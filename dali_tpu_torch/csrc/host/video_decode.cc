// Frame-accurate video reads over the MP4, AVI, Matroska, MPEG-PS and MPEG-TS
// demuxers and the MPEG-4 Part 2, MPEG-1/2, Motion JPEG, HuffYUV, FFV1 and
// raw 4:2:0 decoders: the counterpart of dali_tpu's FFmpeg-backed
// video_decode.cc, with its contract:
//   * fps is the track's average frame rate (25 when it is not positive),
//     the frame count the stts count;
//   * a decoded picture's frame index is its pts in seconds times fps plus
//     0.5, truncated;
//   * a read seeks when its first frame lies behind the decoder or more
//     than 64 frames ahead of it: to the last sync sample at or before the
//     target's timestamp, then decodes forward, dropping frames before it;
//   * after the last sample the reader stays at its end until it seeks;
//   * a 4:2:0 stream (pixel-format class 1 limited range, 2 full range)
//     converts to RGB by the framework's integer BT.601 with nearest
//     chroma, and its planar read copies the 4:2:0 planes; every other
//     stream (class 0: 4:2:2, 4:4:4, grey, packed RGB) converts through the
//     rebuild of libswscale's RGB24 route (sws_rgb.cc), and its planar read
//     fails, as the reference's does; a frame whose format differs from the
//     stream's at open converts through that route too, and fails a planar
//     read with -2 - got;
//   * a picture whose size differs from the size at open (an in-band VOL
//     header that changes it) ends an RGB read as the end of the stream
//     does, and fails a planar read with -2 - got, as the reference's
//     dimension check does.
// A frame reached by seeking and the same frame reached by decoding forward
// are the same bytes: every decode starts from a sync sample.
//
// AVI stores no presentation times, and there the reference's frame index
// (the dts of the packet a picture leaves the decoder with) misplaces the
// pictures of streams with B-VOPs. The port numbers AVI frames in display
// order instead: frame k is the k-th picture FFmpeg's decoder shows over
// the whole stream. Motion JPEG, HuffYUV, FFV1 and raw frames are numbered
// by packet; FFV1's seek points are the packets the index flags as key
// frames and whose first range-coded bit says so (the frames after one keep
// its context states). HuffYUV with per-frame tables carries them in each
// frame, so every HuffYUV packet starts a decode. fps is the stream
// header's dwRate / dwScale, the frame count its dwLength.
//
// MPEG-4 Part 2 (in AVI or MPEG-TS) and MPEG-1/2 (in AVI, MPEG-PS, MPEG-TS
// or an elementary stream) take one route: at open, a pass over the
// picture headers (``HeaderPass``: the decoders with ``headers_only``)
// replays FFmpeg's output order and numbers every picture the whole stream
// shows, in PS, TS and elementary streams by the reference's frame index
// (its best_effort_timestamp: the packet's pts from the demuxer's replay of
// libavformat, else the dts of the packet the picture leaves the decoder
// with, through decode.c's guess_correct_pts), in AVI by display order. The
// MPEG demuxers hand the pass each picture as they split it, so that the
// open reads the file once; an AVI open reads each sample after the index.
// The pass keeps the decoder's state before each packet that holds an
// I-picture (or starts with an I-VOP the container calls a key): the seek
// points. Every seek outside MP4 goes to the first picture in display
// order whose frame index is at or past the target, from the last seek
// point shown at or before it (so an open GOP's leading B-pictures decode
// from the GOP before, and a stream whose timestamps go back, as at a
// splice, reads after a seek as a new handle's forward decode does). The
// frame count of PS and TS is the stream duration libavformat estimates
// from the PES timestamps; an elementary stream's comes from an MPEG-1
// header's bit rate.
//
// Matroska takes AVI's codec dispatch by its tracks' codecs (a
// V_MS/VFW/FOURCC track by its BITMAPINFOHEADER's FourCC). Its frames are
// numbered by their timestamps, as the reference numbers them: MPEG-4 Part
// 2 and MPEG-1/2 through the header pass by pts (a V_MS/VFW/FOURCC track,
// which stores dts, and a packed MPEG-4 bitstream, whose pts belong to the
// packets, in display order as in AVI), the intra-only codecs each frame
// by its own timestamp. fps is the track's DefaultDuration (else
// libavformat's guess from the timestamps), the frame count the Segment's
// duration times it.
//
// Where a file is found: an AVI by its RIFF header, Matroska by its EBML
// magic, MP4 by its first box, MPEG-PS and MPEG-TS by libavformat's probe
// scores over the file's first bytes (so that a stream cut mid-way, which
// starts with no pack header or off the TS sync, is found), an MPEG-1/2
// elementary stream by its sequence header. The decoder of MPEG-1/2 starts
// with the headers of the first packet that holds a sequence header (the
// extradata libavformat extracts), so the pictures of a stream cut before
// one decode as the reference decodes them.
//
// A handle's index grows with the file by about 100-150 bytes a picture
// (``dali_tpu_torch_video_index_bytes``): the sample table, the numbering,
// the seek points (an MPEG-1/2 state, 624 bytes, kept once however many
// GOPs repeat it) and, for PS and TS, one piece a picture or PES packet,
// from which a read walks the container's packets again.
//
// A handle opened from a path holds the sample table and the decoder's
// pictures, not the file: each sample is read from the file when it is
// decoded.
//
// ``dali_tpu_torch_video_read_batch`` runs the reads of several handles at
// once on the task pool (tasking.cc), one task per handle.

#include <fcntl.h>
#include <sys/stat.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <chrono>
#include <climits>
#include <initializer_list>
#include <cmath>
#include <numeric>
#include <cstdio>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

#include "video.h"

extern "C" int64_t dali_tpu_task_submit(void*, void (*)(void*), void*, const int64_t*, int);
extern "C" void dali_tpu_pool_wait_all(void*);
extern "C" int dali_tpu_pool_num_threads(void*);

namespace {

// read results below 0; a planar read stopped by a change of size returns
// -2 - got, which stays above these two
constexpr int kEof = -1;
constexpr int kDamaged = INT_MIN;
constexpr int kUnsupportedRead = INT_MIN + 1;

// what decodes the samples
enum Codec { kMpeg4Mp4, kMpeg4Avi, kMjpegAvi, kRawAvi, kHuffyuvAvi, kFfv1Avi, kMpeg12, kMpeg4Ts };

struct VideoHandle {
  std::vector<uint8_t> data;  // the file's bytes, when opened from memory
  int fd = -1;                // the file, when opened from a path
  uint64_t size = 0;          // the file's size
  std::vector<uint8_t> sample;  // the bytes of the sample being decoded (fd)
  std::vector<uint8_t> decoded;  // Matroska: the sample with its ContentEncoding undone
  video::Track track;
  int codec = kMpeg4Mp4;
  video::Mpeg4Decoder dec;
  video::Mpeg12Decoder m12;
  video::MjpegDecoder mjpeg;
  video::HuffyuvDecoder huffyuv;
  video::Ffv1Decoder ffv1;
  video::Picture raw;      // a raw frame's planes
  bool yv12 = false;       // raw planes stored V before U
  bool full_range = false;
  int format = video::kYuv420p;  // the stream's pixel format at open
  video::BlockReader in;  // MPEG-PS / TS / elementary stream: the walk over the file
  // MPEG-1/2 and MPEG-4 Part 2 packets: the frame index of each shown
  // picture's tag, and of each picture in display order (empty for the
  // intra-only codecs, whose frame k is packet k)
  std::unordered_map<int64_t, int64_t> frame_of_tag;
  std::vector<int64_t> frame_at;
  // The packets a seek may start from, by display position, each with the
  // index of the decoder's state before it (MPEG-1/2 or MPEG-4 Part 2; -1
  // for FFV1); the first is packet 0, in order before any picture. An
  // MPEG-1/2 stream's states repeat from GOP to GOP: each is kept once.
  // Motion JPEG, HuffYUV and raw video keep none: any packet starts a
  // decode.
  struct SeekPoint {
    size_t packet;
    int64_t pos;
    int32_t state;
  };
  std::vector<SeekPoint> seek_points;
  std::vector<video::Mpeg12State> seek_state12;
  std::vector<video::Mpeg4State> seek_state4;
  const video::Picture* shown = nullptr;  // the picture of the last decode
  int64_t shown_total = 0;  // AVI: the pictures the whole stream shows
  bool drained = false;
  int width = 0, height = 0;
  double fps = 25.0;
  int64_t num_frames = 0;
  size_t next_sample = 0;
  int64_t next_frame = 0;
  bool at_end = false;
  std::string error;
  ~VideoHandle() {
    if (fd >= 0) close(fd);
  }
};

// The bytes of sample ``s``, which lies within the file (``*n`` of them);
// null when the file cannot be read there.
const uint8_t* sample_bytes(VideoHandle* v, const video::Sample& s, size_t* n) {
  *n = size_t(s.size);
  if (v->track.content_comp >= 0) {
    // Matroska: the frame's ContentEncoding undone
    const uint8_t* raw;
    if (v->fd < 0) {
      raw = v->data.data() + s.offset;
    } else {
      v->sample.resize(size_t(s.size));
      if (!video::read_at(v->fd, uint64_t(s.offset), v->sample.data(), v->sample.size()))
        return nullptr;
      raw = v->sample.data();
    }
    std::vector<uint8_t> out;
    if (!video::mkv_decode_frame(uint64_t(v->track.content_comp), v->track.comp_settings, raw,
                                 size_t(s.size), &out))
      return nullptr;
    v->decoded.swap(out);
    *n = v->decoded.size();
    return v->decoded.data();
  }
  if (!v->track.pieces.empty()) {
    // MPEG-PS / TS / elementary stream: the walk over the packets that hold them
    v->sample.resize(size_t(s.size));
    return video::read_es(&v->in, v->track, s.offset, s.size, v->sample.data())
               ? v->sample.data() : nullptr;
  }
  if (v->fd < 0) return v->data.data() + s.offset;
  v->sample.resize(size_t(s.size));
  return video::read_at(v->fd, uint64_t(s.offset), v->sample.data(), v->sample.size())
             ? v->sample.data() : nullptr;
}

int64_t sat_i64(double x) {
  const double kLim = 4.6e18;
  if (!(x > -kLim)) return x != x ? 0 : (int64_t)-kLim;
  if (x > kLim) return (int64_t)kLim;
  return (int64_t)x;
}

int64_t pts_to_frame(const VideoHandle* v, int64_t pts) {
  const double start = v->track.start_time == video::kNoPts ? 0.0 : (double)v->track.start_time;
  double sec = ((double)pts - start) * ((double)v->track.tb_num / (double)v->track.timescale);
  return sat_i64(sec * v->fps + 0.5);
}

int64_t read_fail(VideoHandle* v, int r, const std::string& msg) {
  v->error = msg;
  return r == video::kUnsupported ? kUnsupportedRead : kDamaged;
}

// The frame a packet of an intra-only codec shows: in AVI its place, in
// Matroska the frame its timestamp names
int64_t frame_of(const VideoHandle* v, size_t index) {
  return index < v->frame_at.size() ? v->frame_at[index] : int64_t(index);
}

// One packet of an AVI, MPEG-PS, MPEG-TS, Matroska or elementary stream: the
// frame it shows, or -2 for none.
int64_t decode_avi(VideoHandle* v, size_t index, const uint8_t* bytes, size_t size) {
  std::string msg;
  if (v->codec == kMpeg12) {
    int r = v->m12.decode_packet(bytes, size, int64_t(index), false, &msg);
    if (r < 0) return read_fail(v, r, msg);
    if (r == 0) return -2;
    v->shown = &v->m12.output();
    auto it = v->frame_of_tag.find(v->shown->tag);
    if (it == v->frame_of_tag.end())
      return read_fail(v, video::kInvalid, "damaged MPEG-1/2 stream (a picture out of order)");
    return it->second;
  }
  if (v->codec == kMpeg4Avi || v->codec == kMpeg4Ts) {
    int r = v->dec.decode_packet(bytes, size, int64_t(index), false, &msg);
    if (r < 0) return read_fail(v, r, msg);
    if (r == 0) return -2;
    v->shown = &v->dec.output();
    auto it = v->frame_of_tag.find(v->shown->tag);
    if (it == v->frame_of_tag.end())
      return read_fail(v, video::kInvalid, "damaged MPEG-4 Part 2 stream (a VOP out of order)");
    return it->second;
  }
  if (v->codec == kMjpegAvi) {
    int r = v->mjpeg.decode(bytes, size, v->track.height, &msg);
    if (r < 0) return read_fail(v, r, msg);
    v->shown = &v->mjpeg.picture();
    return frame_of(v, index);
  }
  if (v->codec == kHuffyuvAvi || v->codec == kFfv1Avi) {
    int r = v->codec == kHuffyuvAvi ? v->huffyuv.decode(bytes, size, &msg)
                                    : v->ffv1.decode(bytes, size, &msg);
    if (r < 0) return read_fail(v, r, msg);
    v->shown = v->codec == kHuffyuvAvi ? &v->huffyuv.picture() : &v->ffv1.picture();
    return frame_of(v, index);
  }
  video::Picture& p = v->raw;
  const size_t ys = size_t(p.stride_y) * p.rows_y, cs = size_t(p.stride_c) * p.rows_c;
  if (size < ys + 2 * cs)
    return read_fail(v, video::kInvalid, "raw video frame shorter than its size");
  memcpy(p.y.data(), bytes, ys);
  memcpy((v->yv12 ? p.v : p.u).data(), bytes + ys, cs);
  memcpy((v->yv12 ? p.u : p.v).data(), bytes + ys + cs, cs);
  v->shown = &p;
  return frame_of(v, index);
}

// Decodes up to the next picture; returns its frame index, kEof, kDamaged
// or kUnsupportedRead.
int64_t decode_next(VideoHandle* v) {
  while (true) {
    if (!v->at_end && v->next_sample >= v->track.samples.size() &&
        (v->codec == kMpeg4Avi || v->codec == kMpeg4Ts || v->codec == kMpeg12) && !v->drained) {
      // the end of the stream shows the future reference still held
      v->drained = true;
      const bool held = v->codec == kMpeg12 ? v->m12.drain() : v->dec.drain();
      if (held) {
        v->shown = v->codec == kMpeg12 ? &v->m12.output() : &v->dec.output();
        auto it = v->frame_of_tag.find(v->shown->tag);
        if (it != v->frame_of_tag.end()) {
          v->next_frame = it->second + 1;
          return it->second;
        }
      }
    }
    if (v->at_end || v->next_sample >= v->track.samples.size()) {
      v->at_end = true;
      return kEof;
    }
    const video::Sample& s = v->track.samples[v->next_sample++];
    if (s.offset < 0 || s.size <= 0 || uint64_t(s.offset) >= v->size) continue;
    size_t size = 0;
    const uint8_t* bytes = uint64_t(s.size) <= v->size - uint64_t(s.offset)
                               ? sample_bytes(v, s, &size) : nullptr;
    if (!bytes) {
      // a sample cut by the end of the file ends the stream (the decoder
      // still shows the picture it holds)
      v->next_sample = v->track.samples.size();
      continue;
    }
    if (v->codec != kMpeg4Mp4) {
      int64_t idx = decode_avi(v, v->next_sample - 1, bytes, size);
      if (idx == -2) continue;
      if (idx >= 0) v->next_frame = idx + 1;
      return idx;
    }
    std::string msg;
    int r = v->dec.decode(bytes, size, &msg);
    if (r == 1 && !s.discard) {
      int64_t idx = pts_to_frame(v, s.pts);
      v->next_frame = idx + 1;
      v->shown = &v->dec.picture();
      return idx;
    }
    if (r < 0) return read_fail(v, r, msg);
  }
}

// decode_next, except that an AVI read whose first frame lies past the last
// picture the stream shows (Xvid's packed B-VOPs in its last chunk are
// never shown) but within its frame count gets that last picture, as a
// padded read from before it does
int64_t next_for(VideoHandle* v, long target, int got) {
  int64_t idx = decode_next(v);
  if (idx == kEof && got == 0 && v->track.container == video::kAvi && v->shown &&
      v->next_frame == v->shown_total && target >= v->shown_total && target < v->num_frames)
    return target;
  return idx;
}

// Every container but MP4: the first picture in display order whose frame
// index is at or past the target (the intra-only codecs: frame ``target``),
// reached from the last seek point at or before it (an open GOP's leading
// B-pictures need the GOP before theirs), in the state the whole-stream
// decode had there
void seek_display(VideoHandle* v, long target) {
  int64_t pos = target;
  if (!v->frame_at.empty()) {
    pos = 0;
    while (size_t(pos) < v->frame_at.size() && v->frame_at[size_t(pos)] < target) pos++;
  }
  const VideoHandle::SeekPoint* pick = nullptr;
  for (const auto& p : v->seek_points)
    if (p.pos <= pos) pick = &p;
  v->next_sample = pick ? pick->packet : 0;
  const int64_t n = int64_t(v->track.samples.size());
  if ((v->codec == kMjpegAvi || v->codec == kHuffyuvAvi || v->codec == kRawAvi) && n > 0)
    v->next_sample = size_t(std::min(std::max<int64_t>(pos, 0), n - 1));  // every packet
  v->at_end = false;
  v->drained = false;
  v->next_frame = -1;
  const size_t state = pick ? size_t(pick->state) : SIZE_MAX;
  if (v->codec == kMpeg12) {
    v->m12.flush();
    if (state < v->seek_state12.size()) v->m12.restore(v->seek_state12[state]);
  }
  if (v->codec == kMpeg4Avi || v->codec == kMpeg4Ts) {
    v->dec.flush();
    if (state < v->seek_state4.size()) v->dec.restore(v->seek_state4[state]);
  }
  if (v->codec == kFfv1Avi) v->ffv1.flush();
}

void seek_if_needed(VideoHandle* v, long target) {
  if (!(target < v->next_frame || target > v->next_frame + 64)) return;
  if (v->codec != kMpeg4Mp4) return seek_display(v, target);
  const auto& smp = v->track.samples;
  if (smp.empty()) return;
  int64_t ts = sat_i64((double)target / v->fps / (1.0 / (double)v->track.timescale) +
                       (double)v->track.start_time);
  // the last sync sample at or before ts (by dts), else the first sample
  // when ts lies before every sample
  long pick = -1;
  for (size_t i = 0; i < smp.size(); i++) {
    if (smp[i].dts > ts) break;
    if (smp[i].key) pick = long(i);
  }
  if (pick < 0) {
    if (ts < smp[0].dts) pick = 0;
    else return;  // no sync sample before it: the read goes on from here
  }
  v->next_sample = size_t(pick);
  v->at_end = false;
  v->dec.flush();
  v->next_frame = -1;
}

inline unsigned char clamp255(int x) {
  return (unsigned char)(x < 0 ? 0 : (x > 255 ? 255 : x));
}

void picture_to_rgb(const video::Picture& p, int w, int h, bool full, unsigned char* dst) {
  for (int y = 0; y < h; y++) {
    const uint8_t* yp = p.y.data() + (size_t)y * p.stride_y;
    const uint8_t* up = p.u.data() + (size_t)(y >> 1) * p.stride_c;
    const uint8_t* vp = p.v.data() + (size_t)(y >> 1) * p.stride_c;
    unsigned char* d = dst + (size_t)y * w * 3;
    if (full) {
      for (int x = 0; x < w; x++) {
        int Y = 256 * yp[x];
        int D = up[x >> 1] - 128, E = vp[x >> 1] - 128;
        d[3 * x + 0] = clamp255((Y + 359 * E + 128) >> 8);
        d[3 * x + 1] = clamp255((Y - 88 * D - 183 * E + 128) >> 8);
        d[3 * x + 2] = clamp255((Y + 454 * D + 128) >> 8);
      }
    } else {
      for (int x = 0; x < w; x++) {
        int C = 298 * (yp[x] - 16);
        int D = up[x >> 1] - 128, E = vp[x >> 1] - 128;
        d[3 * x + 0] = clamp255((C + 409 * E + 128) >> 8);
        d[3 * x + 1] = clamp255((C - 100 * D - 208 * E + 128) >> 8);
        d[3 * x + 2] = clamp255((C + 516 * D + 128) >> 8);
      }
    }
  }
}

// got, or a read result below 0 when nothing was read (damage and an
// unsupported tool are reported even after frames were read)
int finish(int got, int64_t code) {
  if (code == kEof) return got > 0 ? got : kEof;
  return int(code);
}

bool full_range(const VideoHandle* v) {
  return v->codec == kMpeg4Mp4 ? v->dec.full_range() : v->full_range;
}

bool size_changed(const VideoHandle* v, const video::Picture& p) {
  return p.width != v->width || p.height != v->height;
}

// the time the reads spent in the swscale rebuild, summed over threads, and
// its frames (dali_tpu_torch_sws_clock)
std::atomic<int64_t> sws_ns{0}, sws_frames{0};

// 0: not 4:2:0 (the swscale route), 1: 4:2:0 limited range, 2: full range
int pixfmt_class(const VideoHandle* v) {
  if (v->format != video::kYuv420p) return 0;
  return full_range(v) ? 2 : 1;
}

// One picture to RGB24 as the reference converts it: its own BT.601 for a
// 4:2:0 frame of a 4:2:0 stream, libswscale's route for every other frame.
// False for a form the port does not convert: a 4:2:0 frame in a stream
// that is not 4:2:0, 4:2:2 at an odd width and height.
bool to_rgb(const VideoHandle* v, const video::Picture& p, unsigned char* dst) {
  if (p.format == video::kYuv420p) {
    if (pixfmt_class(v) == 0) return false;
    picture_to_rgb(p, v->width, v->height, full_range(v), dst);
    return true;
  }
  if (!video::sws_takes(p.format, p.width, p.height)) return false;
  const auto t0 = std::chrono::steady_clock::now();
  video::sws_rgb(p, full_range(v), dst);
  sws_ns += std::chrono::duration_cast<std::chrono::nanoseconds>(
                std::chrono::steady_clock::now() - t0).count();
  sws_frames++;
  return true;
}

int read_rgb(VideoHandle* v, long start, int count, int stride, unsigned char* out) {
  long target = start;
  int got = 0;
  seek_if_needed(v, target);
  const size_t frame_bytes = (size_t)v->width * v->height * 3;
  while (got < count) {
    int64_t idx = next_for(v, target, got);
    if (idx < 0) return finish(got, idx);
    if (idx >= target) {
      if (size_changed(v, *v->shown)) return finish(got, kEof);
      if (!to_rgb(v, *v->shown, out + (size_t)got * frame_bytes)) {
        v->error = "a 4:2:0 frame in a stream that is not 4:2:0, or 4:2:2 at an odd width and "
                   "height: libswscale's routes for them are ROADMAP.md Queue 1 item 8b";
        return kUnsupportedRead;
      }
      got++;
      target += stride;
    }
  }
  return got;
}

int read_yuv(VideoHandle* v, long start, int count, int stride, unsigned char* oy,
             unsigned char* ou, unsigned char* ov) {
  if (pixfmt_class(v) == 0) return -1;  // the planar wire is 4:2:0 only
  long target = start;
  int got = 0;
  seek_if_needed(v, target);
  const int w = v->width, h = v->height, cw = (w + 1) / 2, ch = (h + 1) / 2;
  while (got < count) {
    int64_t idx = next_for(v, target, got);
    if (idx < 0) return finish(got, idx);
    if (idx >= target) {
      const video::Picture& p = *v->shown;
      if (size_changed(v, p) || p.format != video::kYuv420p) return -2 - got;
      unsigned char* dy = oy + (size_t)got * h * w;
      unsigned char* du = ou + (size_t)got * ch * cw;
      unsigned char* dv = ov + (size_t)got * ch * cw;
      for (int y = 0; y < h; y++) memcpy(dy + (size_t)y * w, p.y.data() + (size_t)y * p.stride_y, w);
      for (int y = 0; y < ch; y++) {
        memcpy(du + (size_t)y * cw, p.u.data() + (size_t)y * p.stride_c, cw);
        memcpy(dv + (size_t)y * cw, p.v.data() + (size_t)y * p.stride_c, cw);
      }
      got++;
      target += stride;
    }
  }
  return got;
}

struct BatchJob {
  VideoHandle* handle;
  std::vector<int> reqs;  // indices into the request arrays
  const long* starts;
  const int* counts;
  const int* strides;
  unsigned char* const* ys;
  unsigned char* const* us;
  unsigned char* const* vs;
  int* results;
  bool yuv;
};

void run_job(void* arg) {
  auto* j = static_cast<BatchJob*>(arg);
  for (int r : j->reqs) {
    j->results[r] = j->yuv ? read_yuv(j->handle, j->starts[r], j->counts[r], j->strides[r],
                                      j->ys[r], j->us[r], j->vs[r])
                           : read_rgb(j->handle, j->starts[r], j->counts[r], j->strides[r],
                                      j->ys[r]);
  }
}

bool tag_in(uint32_t tag, std::initializer_list<const char*> names) {
  for (const char* n : names)
    if (tag == video::riff_fourcc(n)) return true;
  return false;
}

// The first ``k`` bytes of sample ``s`` into ``dst``; false when they are
// not in the file.
bool read_head(VideoHandle* v, const video::Sample& s, uint8_t* dst, size_t k) {
  if (s.offset < 0 || uint64_t(s.offset) + k > v->size) return false;
  if (v->fd >= 0) return video::read_at(v->fd, uint64_t(s.offset), dst, k);
  memcpy(dst, v->data.data() + s.offset, k);
  return true;
}

// The bytes of sample i (``*n`` of them), or null when they are not all in
// the file.
const uint8_t* whole_sample(VideoHandle* v, size_t i, size_t* n) {
  const video::Sample& s = v->track.samples[i];
  if (s.offset < 0 || s.size <= 0 || uint64_t(s.offset) >= v->size ||
      uint64_t(s.size) > v->size - uint64_t(s.offset))
    return nullptr;
  return sample_bytes(v, s, n);
}

// av_image_check_size2 without a pixel format: (8 w + 1024) (h + 128) below
// 2^31 - 1
bool frame_size_ok(int w, int h) {
  return w > 0 && h > 0 && (8 * int64_t(w) + 1024) * (int64_t(h) + 128) < INT_MAX;
}

// decode.c's guess_correct_pts: the best_effort_timestamp of a frame from
// its packet's pts and the dts of the packet it left the decoder with
struct PtsGuess {
  int64_t faulty_pts = 0, faulty_dts = 0, last_pts = INT64_MIN, last_dts = INT64_MIN;
  int64_t guess(int64_t reordered_pts, int64_t dts) {
    if (dts != video::kNoPts) {
      faulty_dts += dts <= last_dts;
      last_dts = dts;
    } else if (reordered_pts != video::kNoPts) {
      last_dts = reordered_pts;
    }
    if (reordered_pts != video::kNoPts) {
      faulty_pts += reordered_pts <= last_pts;
      last_pts = reordered_pts;
    } else if (dts != video::kNoPts) {
      last_pts = dts;
    }
    if ((faulty_pts <= faulty_dts || dts == video::kNoPts) && reordered_pts != video::kNoPts)
      return reordered_pts;
    return dts;
  }
};

// MPEG-PS, MPEG-TS and elementary streams count no frames: the frame count
// comes from the stream duration libavformat estimates
int64_t es_num_frames(const VideoHandle* v) {
  const video::Track& t = v->track;
  return t.duration > 0
             ? sat_i64(double(t.duration) * (1.0 / double(t.timescale)) * v->fps + 0.5) : 0;
}

// Whether two MPEG-1/2 states are equal field by field (the size check
// fails when a field is added that this does not compare yet)
static_assert(sizeof(video::Mpeg12State) == 624, "same_state compares every field");
bool same_state(const video::Mpeg12State& a, const video::Mpeg12State& b) {
  auto mat = [](const uint16_t* x, const uint16_t* y) { return !memcmp(x, y, 64 * sizeof(*x)); };
  return a.seen == b.seen && a.mpeg2 == b.mpeg2 && a.width == b.width && a.height == b.height &&
         a.aspect == b.aspect && a.frame_rate_index == b.frame_rate_index &&
         a.frame_rate_ext_n == b.frame_rate_ext_n && a.frame_rate_ext_d == b.frame_rate_ext_d &&
         a.bit_rate == b.bit_rate && a.progressive_sequence == b.progressive_sequence &&
         a.chroma_format == b.chroma_format && a.low_delay == b.low_delay &&
         mat(a.intra, b.intra) && mat(a.inter, b.inter) && mat(a.chroma_intra, b.chroma_intra) &&
         mat(a.chroma_inter, b.chroma_inter) && a.full_pel[0] == b.full_pel[0] &&
         a.full_pel[1] == b.full_pel[1] && a.f_code[0][0] == b.f_code[0][0] &&
         a.f_code[0][1] == b.f_code[0][1] && a.f_code[1][0] == b.f_code[1][0] &&
         a.f_code[1][1] == b.f_code[1][1] && a.intra_dc_precision == b.intra_dc_precision &&
         a.picture_structure == b.picture_structure &&
         a.frame_pred_frame_dct == b.frame_pred_frame_dct &&
         a.concealment_mv == b.concealment_mv && a.q_scale_type == b.q_scale_type &&
         a.intra_vlc_format == b.intra_vlc_format && a.alternate_scan == b.alternate_scan &&
         a.progressive_frame == b.progressive_frame;
}

// The pass at open over the picture headers of an MPEG-1/2 or MPEG-4 Part 2
// stream, packet by packet in order: the MPEG demuxers hand it each picture
// as their split finds it (so the open reads the file once), an AVI open
// each sample. It replays FFmpeg's output order with a decoder that parses
// headers and decodes no macroblock, notes each shown picture's tag and
// the packet it left with, and keeps the decoder's state before each packet
// a seek may start from: one holding an I-picture (MPEG-1/2: one decoded,
// not skipped), or starting with an I-VOP that the container calls a key
// (MPEG-4 Part 2).
struct HeaderPass : video::PictureSink {
  VideoHandle* v;
  int mpeg4;              // 1: MPEG-4 Part 2, 0: MPEG-1/2, -1: the track's, at its first picture
  uint32_t tag4;          // MPEG-4 Part 2: the AVI codec tag of its packet mode
  video::Mpeg12Decoder m12;
  video::Mpeg4Decoder m4;
  video::Mpeg12State first;  // MPEG-1/2: the first sequence header's
  int status = video::kOk;   // kUnsupported ends the open
  bool stopped = false;      // damage: the pass stops, the read reports it
  std::string msg;
  size_t packets = 0;
  struct Shown {
    int64_t tag;
    size_t left_with;  // the packet it left the decoder with (SIZE_MAX at the end)
  };
  std::vector<Shown> shown;
  struct Key {
    size_t packet;
    int64_t tag;    // of the I-picture the packet holds; -1: packet 0, before any picture
    int32_t state;  // in the handle's seek_state12 or seek_state4
  };
  std::vector<Key> keys;

  // the index of an MPEG-1/2 state among the last few kept, else a new one
  int32_t keep(const video::Mpeg12State& st) {
    auto& pool = v->seek_state12;
    for (size_t k = pool.size(); k > 0 && k + 8 > pool.size(); k--)
      if (same_state(pool[k - 1], st)) return int32_t(k - 1);
    pool.push_back(st);
    return int32_t(pool.size() - 1);
  }

  HeaderPass(VideoHandle* h, int is_mpeg4, uint32_t tag) : v(h), mpeg4(is_mpeg4), tag4(tag) {}

  // MPEG-4 Part 2: the VOL headers (the extradata, else the bytes before
  // the first GOV or VOP start code of the first packet that has any, as
  // libavformat's extract_extradata takes them)
  static size_t mpeg4_extradata_end(const uint8_t* b, size_t len) {
    for (size_t k = 0; k + 4 <= len; k++)
      if (b[k] == 0 && b[k + 1] == 0 && b[k + 2] == 1 && (b[k + 3] == 0xb3 || b[k + 3] == 0xb6))
        return k;
    return 0;
  }

  void configure(const uint8_t* b, size_t len) {
    std::vector<uint8_t> config = v->track.config;
    if (config.empty() && b) config.assign(b, b + len);
    for (video::Mpeg4Decoder* d : {&v->dec, &m4}) {
      d->set_packet_mode(tag4);
      if (!config.empty() &&
          d->configure(config.data(), config.size(), &msg) == video::kUnsupported) {
        status = video::kUnsupported;
        stopped = true;
        return;
      }
    }
  }

  // MPEG-1/2: libavformat gives the decoder the headers of the first packet
  // that holds a sequence header as its extradata (find_stream_info's
  // extract_extradata: the packet's bytes to the first start code after the
  // sequence header other than an extension), which the decoder reads
  // before its first packet. The packets before that one (a stream cut
  // mid-way) are held until it comes, then decoded with those headers.
  std::vector<std::pair<std::vector<uint8_t>, bool>> held;
  bool primed = false;

  static size_t extradata_end(const uint8_t* b, size_t len) {
    uint32_t st = 0xffffffffu;
    bool found = false;
    for (size_t k = 0; k < len; k++) {
      st = (st << 8) | b[k];
      if (st == 0x1b3) found = true;
      else if (found && st != 0x1b5 && st >= 0x100 && st < 0x200) return k - 3;
    }
    return 0;
  }

  void picture(const uint8_t* b, size_t len, bool key) override {
    if (mpeg4 < 0) mpeg4 = v->track.es_codec == video::kEsMpeg4;
    if (!primed && !v->track.config.empty()) prime(nullptr, 0);  // the container's extradata
    if (!primed) {
      const size_t end = mpeg4 ? mpeg4_extradata_end(b, len) : extradata_end(b, len);
      if (!end) {
        held.push_back({std::vector<uint8_t>(b, b + len), key});
        return;
      }
      prime(b, end);
    }
    take(b, len, key);
  }

  // the extradata's headers (``b``, else the container's, else none), then
  // the packets held for them
  void prime(const uint8_t* b, size_t end) {
    primed = true;
    if (mpeg4) {
      configure(b, end);
    } else if (b || !v->track.config.empty()) {
      m12.decode_packet(b ? b : v->track.config.data(), b ? end : v->track.config.size(), -1,
                        true, &msg);
    }
    for (const auto& h : held) take(h.first.data(), h.first.size(), h.second);
    held = {};
  }

  void take(const uint8_t* b, size_t len, bool key) {
    const size_t i = packets++;
    if (stopped) return;
    if (mpeg4) {
      const video::Mpeg4State before = m4.state();
      if (i == 0) {
        keys.push_back({0, -1, int32_t(v->seek_state4.size())});
        v->seek_state4.push_back(before);
      }
      int64_t first_tag = -1;
      for (size_t k = 0; k + 4 < len; k++)
        if (b[k] == 0 && b[k + 1] == 0 && b[k + 2] == 1 && b[k + 3] == 0xb6) {
          if (!(b[k + 4] >> 6) && key) first_tag = (int64_t(i) << 32) + int64_t(k);
          break;
        }
      const int r = m4.decode_packet(b, len, int64_t(i), true, &msg);
      if (r < 0) return stop(r);
      if (first_tag >= 0) {
        keys.push_back({i, first_tag, int32_t(v->seek_state4.size())});
        v->seek_state4.push_back(before);
      }
      if (r == 1) shown.push_back({m4.output().tag, i});
      return;
    }
    const video::Mpeg12State before = m12.state();
    if (i == 0) keys.push_back({0, -1, keep(before)});
    const int r = m12.decode_packet(b, len, int64_t(i), true, &msg);
    if (!first.seen && m12.state().seen) first = m12.state();
    if (r < 0) return stop(r);
    const bool intra = m12.last_decoded() && m12.last_type() == 1;
    if (intra) keys.push_back({i, int64_t(i), keep(before)});
    if (r == 1) shown.push_back({m12.output().tag, i});
  }

  void stop(int r) {
    stopped = true;
    if (r == video::kUnsupported) status = r;
  }

  // The end of the stream, then the numbering: in MPEG-PS, MPEG-TS and
  // elementary streams each shown picture's frame index is the
  // reference's (its best-effort timestamp from the packet's pts and the
  // dts of the packet it left with, else one past the last), in AVI its
  // place in display order; and the seek points by display position.
  int finish(bool by_pts, std::string* out_msg) {
    if (mpeg4 < 0) mpeg4 = v->track.es_codec == video::kEsMpeg4;
    if (!primed) prime(nullptr, 0);
    if (status != video::kOk) {
      *out_msg = msg;
      return status;
    }
    if (mpeg4 ? m4.drain() : m12.drain())
      shown.push_back({mpeg4 ? m4.output().tag : m12.output().tag, SIZE_MAX});
    const auto& smp = v->track.samples;
    PtsGuess guess;
    int64_t next_idx = 0;
    std::unordered_map<int64_t, int64_t> key_pos;
    for (const Key& k : keys)
      if (k.tag >= 0) key_pos[k.tag] = -1;
    v->frame_at.reserve(shown.size());
    for (const Shown& e : shown) {
      int64_t idx = int64_t(v->frame_at.size());
      if (by_pts) {
        const size_t pkt = size_t(mpeg4 ? e.tag >> 32 : e.tag);
        const int64_t pts = pkt < smp.size() ? smp[pkt].pts : video::kNoPts;
        const int64_t dts = e.left_with < smp.size() ? smp[e.left_with].dts : video::kNoPts;
        const int64_t best = guess.guess(pts, dts);
        idx = best != video::kNoPts ? pts_to_frame(v, best) : next_idx;
      }
      next_idx = idx + 1;
      auto it = key_pos.find(e.tag);
      if (it != key_pos.end()) it->second = int64_t(v->frame_at.size());
      v->frame_of_tag[e.tag] = idx;
      v->frame_at.push_back(idx);
    }
    v->shown_total = int64_t(v->frame_at.size());
    // packet 0, in order before every picture; each packet whose I-picture
    // was shown, at that picture's display position
    for (const Key& k : keys) {
      const int64_t at = k.tag < 0 ? INT64_MIN : key_pos[k.tag];
      if (at != -1) v->seek_points.push_back({k.packet, at, k.state});
    }
    shown = {};
    keys = {};
    return video::kOk;
  }
};

// Feeds an AVI's samples to the header pass, in order, to the first that
// is not in the file.
void pass_avi_samples(VideoHandle* v, HeaderPass* pass) {
  for (size_t i = 0; i < v->track.samples.size(); i++) {
    size_t n;
    const uint8_t* b = whole_sample(v, i, &n);
    if (!b) break;
    pass->picture(b, n, v->track.samples[i].key);
  }
}

// MPEG-1/2 after its header pass: the size and format of the first
// sequence header, the fps and the frame count. Numbered by pts but in AVI
// and in Matroska's V_MS/VFW/FOURCC, which store none.
int open_mpeg12(VideoHandle* v, HeaderPass* pass, std::string* msg) {
  video::Track& t = v->track;
  v->codec = kMpeg12;
  const bool es = t.container != video::kAvi && t.container != video::kMkv;
  if (es) v->fps = (t.fps > 0.0 && std::isfinite(t.fps)) ? t.fps : 25.0;
  const int r = pass->finish(t.container != video::kAvi && !t.ms_compat, msg);
  if (r != video::kOk) return r;
  if (!pass->first.seen) {
    *msg = "no MPEG-1/2 sequence header";
    return video::kInvalid;
  }
  // a new handle's decoder starts as the pass's did: with the extradata's
  // headers
  if (!v->seek_points.empty() && size_t(v->seek_points[0].state) < v->seek_state12.size())
    v->m12.restore(v->seek_state12[size_t(v->seek_points[0].state)]);
  v->width = pass->first.width;
  v->height = pass->first.height;
  v->format = pass->first.chroma_format == 2 ? video::kYuv422p : video::kYuv420p;
  if (es) v->num_frames = es_num_frames(v);
  return video::kOk;
}

// MPEG-4 Part 2 in AVI or in MPEG-TS (numbered by pts) after its header
// pass: the frame size and range of its VOL.
int open_mpeg4_packets(VideoHandle* v, HeaderPass* pass, bool by_pts, std::string* msg) {
  const int r = pass->finish(by_pts, msg);
  if (r != video::kOk) return r;
  v->width = v->dec.width();
  v->height = v->dec.height();
  v->full_range = v->dec.full_range();
  return video::kOk;
}


// avformat_find_stream_info's guess of a frame rate the container does not
// state (a Matroska track without DefaultDuration), from the frames'
// timestamps in order: the greatest common step of more than 15 steps
// when it is coarser than 2 ms (its r_frame_rate), else their mean step
// rounded to a standard rate within 1%
double guess_fps(const VideoHandle* v) {
  std::vector<int64_t> ts;
  for (const auto& s : v->track.samples) {
    const int64_t t = v->track.ms_compat ? s.dts : s.pts;
    if (t != video::kNoPts) ts.push_back(t);
  }
  std::sort(ts.begin(), ts.end());
  ts.erase(std::unique(ts.begin(), ts.end()), ts.end());
  if (ts.size() < 2) return 0.0;
  const double tb = double(v->track.tb_num) / double(v->track.timescale);
  int64_t g = 0;
  for (size_t i = 1; i < ts.size(); i++) g = std::gcd(g, ts[i] - ts[i - 1]);
  if (ts.size() > 16 && double(g) * tb > 0.002) return 1.0 / (double(g) * tb);
  const double raw = double(ts.size() - 1) / (double(ts.back() - ts.front()) * tb);
  double best = 0.0, err = 0.01;
  // get_std_framerate: n/12 for n = 1..360, 61..90, 80, 120, 240, and the
  // 1000/1001 rates of 24, 30, 60, 12, 15 and 48
  auto take = [&](double f) {
    if (std::fabs(raw / f - 1) < err) {
      err = std::fabs(raw / f - 1);
      best = f;
    }
  };
  for (int i = 1; i <= 360; i++) take(i / 12.0);
  for (int i = 61; i <= 90; i++) take(i);
  for (int r : {80, 120, 240}) take(r);
  for (int r : {24, 30, 60, 12, 15, 48}) take(r * 1000.0 / 1001.0);
  return best > 0 ? best : raw;
}

// The frame size and format an open ends with
int check_size(const VideoHandle* v, std::string* msg) {
  if (v->width <= 0 || v->height <= 0) {
    *msg = "no frame size in the stream headers";
    return video::kInvalid;
  }
  if (v->format != video::kYuv420p && !video::sws_takes(v->format, v->width, v->height)) {
    *msg = "4:2:2 video at an odd width and height: libswscale converts it through its "
           "full-chroma bilinear route, ROADMAP.md Queue 1 item 8b";
    return video::kUnsupported;
  }
  return video::kOk;
}

// The decoder of an AVI stream by its codec tag, the frame size, and the
// frame index of every packet a seek may start from.
int open_avi(VideoHandle* v, std::string* msg) {
  video::Track& t = v->track;
  uint32_t tag = 0;  // upper case, as libavformat's tag lookup falls back to
  for (int i = 0; i < 32; i += 8) {
    uint32_t c = (t.codec_tag >> i) & 0xff;
    tag |= (c >= 'a' && c <= 'z' ? c - 32 : c) << i;
  }
  const size_t n = t.samples.size();
  const bool mkv = t.container == video::kMkv;
  if (!mkv) {
    v->num_frames = t.nb_frames > 0 ? t.nb_frames : t.duration;
    v->fps = (t.fps > 0.0 && std::isfinite(t.fps)) ? t.fps : 25.0;
  }
  if (tag_in(tag, {"XVID", "DIVX", "DX50", "FMP4", "MP4V", "MP4S", "M4S2", "DIV1", "BLZ0", "XVIX",
                   "RMP4", "ZMP4", "3IV2", "WV1F", "SEDG", "WAWV", "FFDS", "FVFW", "DCOD", "MVXM",
                   "PM4V", "SMP4", "DXGM", "VIDM", "M4T3", "HDX4", "DM4V", "DMK2", "DYM4", "DIGI",
                   "EPHV", "EM4A", "M4CC", "SN40", "VSPX", "ULDX", "SIPP", "SM4V", "DREX", "QMP4",
                   "PLV1", "GLV4", "GMP4", "MNM4", "GTM4", "UMP4", "GEOV", "GEOX"}) ||
      t.codec_tag == 0x04000000u) {
    // Matroska's V_MPEG4/ISO/* tracks carry no codec tag, and pts (which
    // in a packed stream belong to the packets: numbered in display order)
    const bool native = mkv && !t.ms_compat;
    v->codec = kMpeg4Avi;
    HeaderPass pass(v, 1, native ? 0 : tag);
    pass_avi_samples(v, &pass);
    const int r = open_mpeg4_packets(v, &pass, native && !pass.m4.state().packed, msg);
    if (r != video::kOk) return r;
  } else if (tag_in(tag, {"MJPG", "DMB1", "MJPA", "AVRN", "ACDV", "QIVG", "SLMJ", "CJPG", "IJLV",
                          "MVJ1", "AVI1", "AVI2", "MTSJ", "ZJPG", "MMJP", "JPGL"})) {
    v->codec = kMjpegAvi;
    v->full_range = true;
    v->shown_total = int64_t(n);
    size_t len = 0;
    const uint8_t* b = n ? whole_sample(v, 0, &len) : nullptr;
    if (b) {
      video::MjpegDecoder probe;
      int r = probe.decode(b, len, t.height, msg);
      if (r == video::kUnsupported) return r;
      if (r == 1) {
        v->width = probe.picture().width;
        v->height = probe.picture().height;
        v->format = probe.picture().format;
      }
    }
  } else if (tag_in(tag, {"HFYU", "FFVH", "FFV1"}) && !frame_size_ok(t.width, t.height)) {
    // FFmpeg's av_image_check_size2 refuses the size: its open fails
    *msg = "frame size out of range";
    return video::kInvalid;
  } else if (tag_in(tag, {"HFYU", "FFVH"})) {
    v->codec = kHuffyuvAvi;
    v->shown_total = int64_t(n);
    v->width = t.width;
    v->height = t.height;
    int r = v->huffyuv.configure(t.bits, t.config.data(), t.config.size(), t.width, t.height, msg);
    if (r != video::kOk) return r;
    v->format = v->huffyuv.format();
  } else if (tag_in(tag, {"FFV1"})) {
    v->codec = kFfv1Avi;
    v->shown_total = int64_t(n);
    v->width = t.width;
    v->height = t.height;
    int r = v->ffv1.configure(t.config.data(), t.config.size(), t.width, t.height, msg);
    if (r != video::kOk) return r;
    // the seek points: packets the index and the frame's own bit call key
    std::vector<bool> keys(n, false);
    for (size_t i = 0; i < n; i++) {
      const video::Sample& s = t.samples[i];
      uint8_t head[2];
      if (t.content_comp >= 0) {
        size_t len;
        const uint8_t* b = s.key ? whole_sample(v, i, &len) : nullptr;
        keys[i] = b && video::Ffv1Decoder::is_key(b, len);
        continue;
      }
      keys[i] = s.key && s.size >= 2 && read_head(v, s, head, 2) &&
                video::Ffv1Decoder::is_key(head, 2);
    }
    // FFV1: frame k is packet k, a seek starts at a key packet
    v->seek_points.push_back({0, INT64_MIN, -1});
    for (size_t i = 0; i < n; i++)
      if (keys[i]) v->seek_points.push_back({i, int64_t(i), -1});
    v->format = v->ffv1.format();
    if (v->format < 0) {
      // versions 0 and 1 state the format in their first key frame
      video::Ffv1Decoder probe;
      probe.configure(t.config.data(), t.config.size(), t.width, t.height, msg);
      for (size_t i = 0; i < n && v->format < 0; i++) {
        if (!keys[i]) continue;
        size_t len;
        const uint8_t* b = whole_sample(v, i, &len);
        if (!b) break;
        r = probe.decode(b, len, msg);
        if (r == video::kUnsupported) return r;
        v->format = probe.format();
        break;
      }
      if (v->format < 0) v->format = video::kYuv420p;
    }
  } else if (tag_in(tag, {"MPG1", "MPG2", "PIM1", "MPEG", "MPGI", "MMES"}) ||
             t.codec_tag == 0x10000001u || t.codec_tag == 0x10000002u) {
    HeaderPass pass(v, 0, 0);
    pass_avi_samples(v, &pass);
    const int r = open_mpeg12(v, &pass, msg);
    if (r != video::kOk) return r;
  } else if (tag_in(tag, {"I420", "IYUV", "YV12"})) {
    v->codec = kRawAvi;
    v->shown_total = int64_t(n);
    v->yv12 = tag_in(tag, {"YV12"});
    v->width = t.width;
    v->height = t.height;
    video::Picture& p = v->raw;
    p.allocate(video::kYuv420p, t.width, t.height);
  } else {
    std::string what;
    if (tag_in(tag, {"H264", "X264", "AVC1", "DAVC", "VSSH", "Q264", "V264", "GAVC"}))
      what = "H.264";
    else if (tag_in(tag, {"HEVC", "H265", "HVC1"})) what = "HEVC";
    else if (t.codec_tag == 0) what = "uncompressed RGB";
    else {
      char cc[5] = {char(t.codec_tag), char(t.codec_tag >> 8), char(t.codec_tag >> 16),
                    char(t.codec_tag >> 24), 0};
      what = std::string("'") + cc + "'";
    }
    *msg = what + " video in AVI: the port decodes MPEG-1/2, MPEG-4 Part 2, Motion JPEG, "
                  "HuffYUV, FFV1 and raw 4:2:0 in AVI; H.264, HEVC, uncompressed RGB and the "
                  "rest are ROADMAP.md Queue 1 item 8b";
    return video::kUnsupported;
  }
  return check_size(v, msg);
}

// av_probe_input_buffer2 between MPEG-PS and MPEG-TS (a stream cut mid-way
// scores by its packets): the first 2 KiB, then twice as many bytes each
// time up to a MiB, until one scores above 25, or above 0 once the whole
// file is in; MPEG-PS on a tie, as it is registered first. kMpegPs,
// kMpegTs, or 0 for neither.
int sniff_mpeg(video::BlockReader* in) {
  constexpr uint64_t kMax = uint64_t(1) << 20;
  uint64_t seen = 0;
  for (uint64_t probe = 2048;; probe = std::min(probe * 2, kMax)) {
    const bool eof = seen > 0 && seen >= in->size;
    const size_t n = size_t(std::min(probe, in->size));
    const uint8_t* head = in->at(0, n);
    if (!head) return 0;
    const int ps = video::mpegps_probe(head, n), ts = video::mpegts_probe(head, n);
    if (std::max(ps, ts) > (probe < kMax && !eof ? 25 : 0))
      return ps >= ts ? video::kMpegPs : video::kMpegTs;
    if (eof || probe >= kMax) return 0;
    seen = n;
  }
}

// Matroska: the codec by its tag as open_avi dispatches it, the fps from
// the track's DefaultDuration (else the timestamps), the frame count from
// the Segment's duration, and for the intra-only codecs each frame's index
// from its timestamp (a frame without one follows the frame before)
int open_mkv(VideoHandle* v, std::string* msg) {
  video::Track& t = v->track;
  const double fps = t.fps > 0.0 && std::isfinite(t.fps) ? t.fps : guess_fps(v);
  v->fps = fps > 0.0 && std::isfinite(fps) ? fps : 25.0;
  const int r = open_avi(v, msg);
  if (r != video::kOk) return r;
  v->num_frames = t.format_duration != video::kNoPts
                      ? sat_i64(double(t.format_duration) / 1000000.0 * v->fps + 0.5) : 0;
  if (v->codec == kMjpegAvi || v->codec == kHuffyuvAvi || v->codec == kFfv1Avi ||
      v->codec == kRawAvi) {
    v->frame_at.resize(t.samples.size());
    int64_t next = 0;
    for (size_t i = 0; i < t.samples.size(); i++) {
      const int64_t ts = t.ms_compat ? t.samples[i].dts : t.samples[i].pts;
      v->frame_at[i] = ts != video::kNoPts ? pts_to_frame(v, ts) : next;
      next = v->frame_at[i] + 1;
    }
  }
  return video::kOk;
}

}  // namespace

namespace video {

void Picture::allocate(int fmt, int w, int h) {
  format = fmt;
  width = w;
  height = h;
  rows_y = h;
  stride_y = fmt == kBgr0 || fmt == kBgra || fmt == k0rgb ? 4 * w : (fmt == kBgr24 ? 3 * w : w);
  stride_c = fmt == kYuv444p ? w : (fmt == kYuv420p || fmt == kYuv422p ? (w + 1) / 2 : 0);
  rows_c = fmt == kYuv420p ? (h + 1) / 2 : (stride_c ? h : 0);
  y.assign(size_t(stride_y) * rows_y, 0);
  u.assign(size_t(stride_c) * rows_c, 0);
  v.assign(size_t(stride_c) * rows_c, 0);
}

}  // namespace video

extern "C" {

// Opens a file (``path``) or a buffer (``data``/``n``). On failure returns
// null with ``*kind`` 1 (not a readable video: the reference's open fails
// too) or 2 (unsupported by the port, ROADMAP item 8b) and the reason in
// ``err``.
void* dali_tpu_torch_video_open(const char* path, const unsigned char* data, size_t n,
                                char* err, int errlen, int* kind) {
  auto* v = new VideoHandle();
  auto fail = [&](int k, const std::string& m) -> void* {
    *kind = k;
    snprintf(err, size_t(errlen), "%s", m.c_str());
    delete v;
    return nullptr;
  };
  std::string msg;
  int r;
  uint8_t head[3 * 188];
  size_t head_n = 0;
  if (path) {
    v->fd = ::open(path, O_RDONLY | O_CLOEXEC);
    if (v->fd < 0) return fail(1, "cannot open the file");
    struct stat st;
    if (fstat(v->fd, &st) != 0) return fail(1, "cannot read the file");
    v->size = uint64_t(st.st_size);
    head_n = size_t(std::min<uint64_t>(v->size, sizeof(head)));
    if (!video::read_at(v->fd, 0, head, head_n)) head_n = 0;
  } else {
    v->data.assign(data, data + n);
    v->size = n;
    head_n = std::min(n, sizeof(head));
    if (head_n) memcpy(head, data, head_n);
  }
  const uint8_t* mem = path ? nullptr : v->data.data();
  // MPEG-PS, MPEG-TS and elementary streams: the header pass runs as the
  // demuxer reads the file, and reads walk it from the demuxer's pieces
  HeaderPass pass(v, -1, 0);
  v->in.fd = v->fd;
  v->in.mem = mem;
  v->in.size = v->size;
  v->in.block = size_t(1) << 16;
  const bool mkv = video::is_mkv(head, head_n);
  const int mpeg =
      video::is_avi(head, head_n) || video::is_mp4(head, head_n) || mkv ? 0 : sniff_mpeg(&v->in);
  if (mkv) {
    r = video::demux_mkv_fd(v->fd, mem, v->size, &v->track, &msg);
  } else if (video::is_avi(head, head_n)) {
    r = mem ? video::demux_avi(mem, v->size, &v->track, &msg)
            : video::demux_avi_fd(v->fd, v->size, &v->track, &msg);
  } else if (mpeg == video::kMpegPs) {
    r = video::demux_mpeg_ps_fd(v->fd, mem, v->size, &v->track, &msg, &pass);
  } else if (mpeg == video::kMpegTs) {
    r = video::demux_mpeg_ts_fd(v->fd, mem, v->size, &v->track, &msg, &pass);
  } else if (video::is_mpeg_es(head, head_n)) {
    r = video::demux_mpeg_es_fd(v->fd, mem, v->size, &v->track, &msg, &pass);
  } else {
    r = mem ? video::demux_mp4(mem, v->size, &v->track, &msg)
            : video::demux_mp4_fd(v->fd, v->size, &v->track, &msg);
  }
  if (r != video::kOk) return fail(r == video::kUnsupported ? 2 : 1, msg);
  if (v->track.container != video::kMp4) {
    if (v->track.container == video::kAvi) r = open_avi(v, &msg);
    else if (v->track.container == video::kMkv) r = open_mkv(v, &msg);
    else if (v->track.es_codec == video::kEsMpeg4) {
      v->codec = kMpeg4Ts;
      v->fps = (v->track.fps > 0.0 && std::isfinite(v->track.fps)) ? v->track.fps : 25.0;
      r = open_mpeg4_packets(v, &pass, true, &msg);
      v->num_frames = es_num_frames(v);
    } else {
      r = open_mpeg12(v, &pass, &msg);
    }
    if (r == video::kOk) r = check_size(v, &msg);
    if (r != video::kOk) return fail(r == video::kUnsupported ? 2 : 1, msg);
    // the index is built: its vectors' slack goes
    v->track.samples.shrink_to_fit();
    v->track.pieces.shrink_to_fit();
    v->frame_at.shrink_to_fit();
    v->seek_points.shrink_to_fit();
    v->seek_state12.shrink_to_fit();
    v->seek_state4.shrink_to_fit();
    return v;
  }
  if (!v->track.config.empty()) {
    r = v->dec.configure(v->track.config.data(), v->track.config.size(), &msg);
    if (r == video::kUnsupported) return fail(2, msg);
  }
  v->width = v->dec.width();
  v->height = v->dec.height();
  if (v->width <= 0 || v->height <= 0) {
    // no VOL in the sample description: the first sample carries it
    for (const auto& s : v->track.samples) {
      if (s.offset < 0 || s.size <= 0 || uint64_t(s.offset) >= v->size ||
          uint64_t(s.size) > v->size - uint64_t(s.offset))
        break;
      size_t len;
      const uint8_t* bytes = sample_bytes(v, s, &len);
      if (!bytes) break;
      video::Mpeg4Decoder probe;
      r = probe.configure(bytes, len, &msg);
      if (r == video::kUnsupported) return fail(2, msg);
      v->width = probe.width();
      v->height = probe.height();
      break;
    }
  }
  if (v->width <= 0 || v->height <= 0) return fail(1, "no frame size in the stream headers");
  double fps = v->track.fps;
  v->fps = (fps > 0.0 && std::isfinite(fps)) ? fps : 25.0;
  v->num_frames = v->track.nb_frames;
  if (v->num_frames <= 0 && v->track.duration > 0)
    v->num_frames = sat_i64((double)v->track.duration / (double)v->track.timescale * v->fps + 0.5);
  return v;
}

int dali_tpu_torch_video_info(void* handle, int* w, int* h, long* frames, double* fps) {
  auto* v = static_cast<VideoHandle*>(handle);
  if (!v) return -1;
  *w = v->width;
  *h = v->height;
  *frames = (long)v->num_frames;
  *fps = v->fps;
  return 0;
}

// 0 = not 4:2:0 (the RGB read only), 1 = 4:2:0 limited range, 2 = 4:2:0
// full range (the VO header's video_range, or a yuvj format)
int dali_tpu_torch_video_pixfmt_class(void* handle) {
  auto* v = static_cast<VideoHandle*>(handle);
  if (!v) return 0;
  return pixfmt_class(v);
}

// the codec and container, as the damage reports name them
const char* dali_tpu_torch_video_codec(void* handle) {
  auto* v = static_cast<VideoHandle*>(handle);
  if (!v) return "";
  switch (v->codec) {
    case kMpeg4Avi: return "MPEG-4 Part 2 (AVI)";
    case kMjpegAvi: return "Motion JPEG (AVI)";
    case kRawAvi: return "raw 4:2:0 (AVI)";
    case kHuffyuvAvi: return "HuffYUV (AVI)";
    case kFfv1Avi: return "FFV1 (AVI)";
    case kMpeg12: return "MPEG-1/2 video";
    case kMpeg4Ts: return "MPEG-4 Part 2 (MPEG-TS)";
    default: return "MPEG-4 Part 2";
  }
}

const char* dali_tpu_torch_video_error(void* handle) {
  auto* v = static_cast<VideoHandle*>(handle);
  return v ? v->error.c_str() : "";
}

int dali_tpu_torch_video_read_frames(void* handle, long start, int count, int stride,
                                     unsigned char* out) {
  auto* v = static_cast<VideoHandle*>(handle);
  if (!v) return -1;
  return read_rgb(v, start, count, stride, out);
}

int dali_tpu_torch_video_read_frames_yuv(void* handle, long start, int count, int stride,
                                         unsigned char* out_y, unsigned char* out_u,
                                         unsigned char* out_v) {
  auto* v = static_cast<VideoHandle*>(handle);
  if (!v) return -1;
  return read_yuv(v, start, count, stride, out_y, out_u, out_v);
}

// ``n`` reads, grouped into one task per distinct handle (a handle's reads
// run in order); RGB into ``ys`` when ``yuv`` is 0. A null pool, or one of
// one thread, reads inline.
void dali_tpu_torch_video_read_batch(void* pool, void* const* handles, const long* starts,
                                     const int* counts, const int* strides,
                                     unsigned char* const* ys, unsigned char* const* us,
                                     unsigned char* const* vs, int n, int yuv, int* results) {
  std::vector<BatchJob> jobs;
  for (int i = 0; i < n; i++) {
    auto* h = static_cast<VideoHandle*>(handles[i]);
    BatchJob* j = nullptr;
    for (auto& e : jobs)
      if (e.handle == h) j = &e;
    if (!j) {
      jobs.push_back({h, {}, starts, counts, strides, ys, us, vs, results, yuv != 0});
      j = &jobs.back();
    }
    j->reqs.push_back(i);
  }
  const bool inline_run = pool == nullptr || dali_tpu_pool_num_threads(pool) <= 1;
  for (auto& j : jobs) {
    if (inline_run) run_job(&j);
    else dali_tpu_task_submit(pool, run_job, &j, nullptr, 0);
  }
  if (!inline_run) dali_tpu_pool_wait_all(pool);
}

void dali_tpu_torch_video_close(void* handle) { delete static_cast<VideoHandle*>(handle); }

// The bytes a handle's index of the file holds on the heap, which grow with
// the file's length: the sample table, the pieces of an MPEG-PS or TS, the
// frame numbering and the seek points with their decoder states (the
// pictures and read buffers, whose size does not, are left out).
long dali_tpu_torch_video_index_bytes(void* handle) {
  auto* v = static_cast<VideoHandle*>(handle);
  if (!v) return 0;
  const video::Track& t = v->track;
  size_t b = t.samples.capacity() * sizeof(video::Sample) +
             t.pieces.capacity() * sizeof(video::EsPiece) + t.config.capacity() +
             v->frame_at.capacity() * sizeof(int64_t) +
             v->seek_points.capacity() * sizeof(VideoHandle::SeekPoint) +
             v->seek_state12.capacity() * sizeof(video::Mpeg12State) +
             v->seek_state4.capacity() * sizeof(video::Mpeg4State);
  // an unordered_map node: the key and value and the next pointer, and
  // one bucket pointer
  b += v->frame_of_tag.size() * (2 * sizeof(int64_t) + sizeof(void*)) +
       v->frame_of_tag.bucket_count() * sizeof(void*);
  return long(b);
}

// The seconds the RGB reads spent converting through the swscale rebuild
// (summed over the threads that read) and the frames they converted since
// the last reset; ``reset`` sets both to 0 after reading them.
void dali_tpu_torch_sws_clock(int reset, double* seconds, long* frames) {
  *seconds = double(reset ? sws_ns.exchange(0) : sws_ns.load()) * 1e-9;
  *frames = long(reset ? sws_frames.exchange(0) : sws_frames.load());
}

}  // extern "C"
