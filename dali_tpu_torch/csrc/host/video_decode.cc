// Frame-accurate video reads over the MP4 and AVI demuxers and the MPEG-4
// Part 2, Motion JPEG, HuffYUV, FFV1 and raw 4:2:0 decoders: the counterpart
// of dali_tpu's FFmpeg-backed video_decode.cc, with its contract:
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
// the whole stream. At open, a pass over the packets that parses the VOP
// headers only (``Mpeg4Decoder::decode_packet`` with ``headers_only``)
// gives each shown VOP its index and, for each packet that starts with an
// I-VOP, the index of that I-VOP and the decoder's state there; a seek goes
// to the last such packet whose I-VOP is at or before the target, in the
// state the whole-stream decode had there. Motion JPEG, HuffYUV, FFV1 and
// raw frames are numbered by packet; a seek into FFV1 starts at the last
// packet at or before the target that the index flags as a key frame and
// whose first range-coded bit says so (the frames after it keep its context
// states). HuffYUV with per-frame tables carries them in each frame, so
// every HuffYUV packet starts a decode. fps is the stream header's dwRate /
// dwScale, the frame count its dwLength.
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

#include <atomic>
#include <chrono>
#include <climits>
#include <initializer_list>
#include <cmath>
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
enum Codec { kMpeg4Mp4, kMpeg4Avi, kMjpegAvi, kRawAvi, kHuffyuvAvi, kFfv1Avi };

struct VideoHandle {
  std::vector<uint8_t> data;  // the file's bytes, when opened from memory
  int fd = -1;                // the file, when opened from a path
  uint64_t size = 0;          // the file's size
  std::vector<uint8_t> sample;  // the bytes of the sample being decoded (fd)
  video::Track track;
  int codec = kMpeg4Mp4;
  video::Mpeg4Decoder dec;
  video::MjpegDecoder mjpeg;
  video::HuffyuvDecoder huffyuv;
  video::Ffv1Decoder ffv1;
  video::Picture raw;      // a raw frame's planes
  bool yv12 = false;       // raw planes stored V before U
  bool full_range = false;
  int format = video::kYuv420p;  // the stream's pixel format at open
  // AVI: the frame index of each shown VOP's tag; per packet, the frame
  // index of the I-VOP it starts with (-1 for none) and the decoder state
  // before it
  std::unordered_map<int64_t, int64_t> frame_of_tag;
  std::vector<int64_t> key_frame;
  std::vector<video::Mpeg4State> key_state;
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

// The bytes of sample ``s``, which lies within the file; null when the file
// cannot be read there.
const uint8_t* sample_bytes(VideoHandle* v, const video::Sample& s) {
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
  double sec = ((double)pts - (double)v->track.start_time) * (1.0 / (double)v->track.timescale);
  return sat_i64(sec * v->fps + 0.5);
}

int64_t read_fail(VideoHandle* v, int r, const std::string& msg) {
  v->error = msg;
  return r == video::kUnsupported ? kUnsupportedRead : kDamaged;
}

// One AVI packet: the frame it shows, or -2 for none.
int64_t decode_avi(VideoHandle* v, size_t index, const uint8_t* bytes, size_t size) {
  std::string msg;
  if (v->codec == kMpeg4Avi) {
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
    return int64_t(index);
  }
  if (v->codec == kHuffyuvAvi || v->codec == kFfv1Avi) {
    int r = v->codec == kHuffyuvAvi ? v->huffyuv.decode(bytes, size, &msg)
                                    : v->ffv1.decode(bytes, size, &msg);
    if (r < 0) return read_fail(v, r, msg);
    v->shown = v->codec == kHuffyuvAvi ? &v->huffyuv.picture() : &v->ffv1.picture();
    return int64_t(index);
  }
  video::Picture& p = v->raw;
  const size_t ys = size_t(p.stride_y) * p.rows_y, cs = size_t(p.stride_c) * p.rows_c;
  if (size < ys + 2 * cs)
    return read_fail(v, video::kInvalid, "raw video frame shorter than its size");
  memcpy(p.y.data(), bytes, ys);
  memcpy((v->yv12 ? p.v : p.u).data(), bytes + ys, cs);
  memcpy((v->yv12 ? p.u : p.v).data(), bytes + ys + cs, cs);
  v->shown = &p;
  return int64_t(index);
}

// Decodes up to the next picture; returns its frame index, kEof, kDamaged
// or kUnsupportedRead.
int64_t decode_next(VideoHandle* v) {
  while (true) {
    if (!v->at_end && v->next_sample >= v->track.samples.size() && v->codec == kMpeg4Avi &&
        !v->drained) {
      // the end of the stream shows the future reference still held
      v->drained = true;
      if (v->dec.drain()) {
        v->shown = &v->dec.output();
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
    size_t size = size_t(s.size);
    const uint8_t* bytes = uint64_t(s.size) <= v->size - uint64_t(s.offset)
                               ? sample_bytes(v, s) : nullptr;
    if (!bytes) {
      // a sample cut by the end of the file ends the stream
      v->at_end = true;
      return kEof;
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
  if (idx == kEof && got == 0 && v->codec != kMpeg4Mp4 && v->shown &&
      v->next_frame == v->shown_total && target >= v->shown_total && target < v->num_frames)
    return target;
  return idx;
}

// AVI: the last packet that starts with an I-VOP (any packet of Motion
// JPEG, HuffYUV or raw video, an FFV1 key frame) whose frame is at or
// before the target
void seek_avi(VideoHandle* v, long target) {
  long pick = 0;
  for (size_t i = 0; i < v->key_frame.size(); i++)
    if (v->key_frame[i] >= 0 && v->key_frame[i] <= target) pick = long(i);
  v->next_sample = size_t(pick);
  v->at_end = false;
  v->drained = false;
  v->next_frame = -1;
  if (v->codec == kMpeg4Avi) {
    v->dec.flush();
    if (size_t(pick) < v->key_state.size()) v->dec.restore(v->key_state[size_t(pick)]);
  }
  if (v->codec == kFfv1Avi) v->ffv1.flush();
}

void seek_if_needed(VideoHandle* v, long target) {
  if (!(target < v->next_frame || target > v->next_frame + 64)) return;
  if (v->codec != kMpeg4Mp4) return seek_avi(v, target);
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

// The bytes of sample i, or null when they are not all in the file.
const uint8_t* whole_sample(VideoHandle* v, size_t i) {
  const video::Sample& s = v->track.samples[i];
  if (s.offset < 0 || s.size <= 0 || uint64_t(s.offset) >= v->size ||
      uint64_t(s.size) > v->size - uint64_t(s.offset))
    return nullptr;
  return sample_bytes(v, s);
}

// av_image_check_size2 without a pixel format: (8 w + 1024) (h + 128) below
// 2^31 - 1
bool frame_size_ok(int w, int h) {
  return w > 0 && h > 0 && (8 * int64_t(w) + 1024) * (int64_t(h) + 128) < INT_MAX;
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
  v->num_frames = t.nb_frames > 0 ? t.nb_frames : t.duration;
  v->fps = (t.fps > 0.0 && std::isfinite(t.fps)) ? t.fps : 25.0;
  v->key_frame.assign(n, -1);
  if (tag_in(tag, {"XVID", "DIVX", "DX50", "FMP4", "MP4V", "MP4S", "M4S2", "DIV1", "BLZ0", "XVIX",
                   "RMP4", "ZMP4", "3IV2", "WV1F", "SEDG", "WAWV", "FFDS", "FVFW", "DCOD", "MVXM",
                   "PM4V", "SMP4", "DXGM", "VIDM", "M4T3", "HDX4", "DM4V", "DMK2", "DYM4", "DIGI",
                   "EPHV", "EM4A", "M4CC", "SN40", "VSPX", "ULDX", "SIPP", "SM4V", "DREX", "QMP4",
                   "PLV1", "GLV4", "GMP4", "MNM4", "GTM4", "UMP4", "GEOV", "GEOX"}) ||
      t.codec_tag == 0x04000000u) {
    v->codec = kMpeg4Avi;
    // without extradata the headers before the first VOP stand in for it,
    // as libavformat extracts them
    std::vector<uint8_t> config = t.config;
    if (config.empty() && n) {
      const uint8_t* b = whole_sample(v, 0);
      size_t k = 0, len = b ? size_t(t.samples[0].size) : 0;
      while (k + 4 <= len && !(b[k] == 0 && b[k + 1] == 0 && b[k + 2] == 1 && b[k + 3] == 0xb6))
        k++;
      if (b && k + 4 <= len) config.assign(b, b + k);
    }
    video::Mpeg4Decoder sim;
    for (video::Mpeg4Decoder* d : {&v->dec, &sim}) {
      d->set_packet_mode(tag);
      if (!config.empty() && d->configure(config.data(), config.size(), msg) == video::kUnsupported)
        return video::kUnsupported;
    }
    v->width = v->dec.width();
    v->height = v->dec.height();
    v->full_range = v->dec.full_range();
    // the whole stream's shown pictures, from its VOP headers
    v->key_state.resize(n);
    std::vector<int64_t> first_tag(n, -1);
    int64_t shown = 0;
    for (size_t i = 0; i < n; i++) {
      const uint8_t* b = whole_sample(v, i);
      if (!b) break;
      const size_t len = size_t(t.samples[i].size);
      v->key_state[i] = sim.state();
      for (size_t k = 0; k + 4 < len; k++)
        if (b[k] == 0 && b[k + 1] == 0 && b[k + 2] == 1 && b[k + 3] == 0xb6) {
          if (!(b[k + 4] >> 6) && t.samples[i].key) first_tag[i] = (int64_t(i) << 32) + int64_t(k);
          break;
        }
      int r = sim.decode_packet(b, len, int64_t(i), true, msg);
      if (r == video::kUnsupported) return r;
      if (r < 0) break;  // damage: the read reports it
      if (r == 1) v->frame_of_tag[sim.output().tag] = shown++;
    }
    if (sim.drain()) v->frame_of_tag[sim.output().tag] = shown++;
    v->shown_total = shown;
    for (size_t i = 0; i < n; i++) {
      auto it = first_tag[i] >= 0 ? v->frame_of_tag.find(first_tag[i]) : v->frame_of_tag.end();
      if (it != v->frame_of_tag.end()) v->key_frame[i] = it->second;
    }
  } else if (tag_in(tag, {"MJPG", "DMB1", "MJPA", "AVRN", "ACDV", "QIVG", "SLMJ", "CJPG", "IJLV",
                          "MVJ1", "AVI1", "AVI2", "MTSJ", "ZJPG", "MMJP", "JPGL"})) {
    v->codec = kMjpegAvi;
    v->full_range = true;
    v->shown_total = int64_t(n);
    for (size_t i = 0; i < n; i++) v->key_frame[i] = int64_t(i);
    const uint8_t* b = n ? whole_sample(v, 0) : nullptr;
    if (b) {
      video::MjpegDecoder probe;
      int r = probe.decode(b, size_t(t.samples[0].size), t.height, msg);
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
    for (size_t i = 0; i < n; i++) v->key_frame[i] = int64_t(i);
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
    for (size_t i = 0; i < n; i++) {
      const video::Sample& s = t.samples[i];
      uint8_t head[2];
      if (s.key && s.size >= 2 && read_head(v, s, head, 2) && video::Ffv1Decoder::is_key(head, 2))
        v->key_frame[i] = int64_t(i);
    }
    v->format = v->ffv1.format();
    if (v->format < 0) {
      // versions 0 and 1 state the format in their first key frame
      video::Ffv1Decoder probe;
      probe.configure(t.config.data(), t.config.size(), t.width, t.height, msg);
      for (size_t i = 0; i < n && v->format < 0; i++) {
        if (v->key_frame[i] < 0) continue;
        const uint8_t* b = whole_sample(v, i);
        if (!b) break;
        r = probe.decode(b, size_t(t.samples[i].size), msg);
        if (r == video::kUnsupported) return r;
        v->format = probe.format();
        break;
      }
      if (v->format < 0) v->format = video::kYuv420p;
    }
  } else if (tag_in(tag, {"I420", "IYUV", "YV12"})) {
    v->codec = kRawAvi;
    v->shown_total = int64_t(n);
    v->yv12 = tag_in(tag, {"YV12"});
    v->width = t.width;
    v->height = t.height;
    for (size_t i = 0; i < n; i++) v->key_frame[i] = int64_t(i);
    video::Picture& p = v->raw;
    p.allocate(video::kYuv420p, t.width, t.height);
  } else {
    std::string what;
    if (tag_in(tag, {"MPG1", "MPG2", "PIM1", "MPEG", "MPGI", "MMES", "MPG4"}) ||
        t.codec_tag == 0x10000001u || t.codec_tag == 0x10000002u)
      what = "MPEG-1/2";
    else if (tag_in(tag, {"H264", "X264", "AVC1", "DAVC", "VSSH", "Q264", "V264", "GAVC"}))
      what = "H.264";
    else if (tag_in(tag, {"HEVC", "H265", "HVC1"})) what = "HEVC";
    else if (t.codec_tag == 0) what = "uncompressed RGB";
    else {
      char cc[5] = {char(t.codec_tag), char(t.codec_tag >> 8), char(t.codec_tag >> 16),
                    char(t.codec_tag >> 24), 0};
      what = std::string("'") + cc + "'";
    }
    *msg = what + " video in AVI: the port decodes MPEG-4 Part 2, Motion JPEG, HuffYUV, FFV1 "
                  "and raw 4:2:0 in AVI; MPEG-1/2, H.264, HEVC, uncompressed RGB and the rest are "
                  "ROADMAP.md Queue 1 item 8b";
    return video::kUnsupported;
  }
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
  if (path) {
    v->fd = ::open(path, O_RDONLY | O_CLOEXEC);
    if (v->fd < 0) return fail(1, "cannot open the file");
    struct stat st;
    if (fstat(v->fd, &st) != 0) return fail(1, "cannot read the file");
    v->size = uint64_t(st.st_size);
    uint8_t head[12];
    bool avi = v->size >= 12 && video::read_at(v->fd, 0, head, 12) && video::is_avi(head, 12);
    r = avi ? video::demux_avi_fd(v->fd, v->size, &v->track, &msg)
            : video::demux_mp4_fd(v->fd, v->size, &v->track, &msg);
  } else {
    v->data.assign(data, data + n);
    v->size = n;
    r = video::is_avi(v->data.data(), v->data.size())
            ? video::demux_avi(v->data.data(), v->data.size(), &v->track, &msg)
            : video::demux_mp4(v->data.data(), v->data.size(), &v->track, &msg);
  }
  if (r != video::kOk) return fail(r == video::kUnsupported ? 2 : 1, msg);
  if (v->track.avi) {
    r = open_avi(v, &msg);
    if (r != video::kOk) return fail(r == video::kUnsupported ? 2 : 1, msg);
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
      const uint8_t* bytes = sample_bytes(v, s);
      if (!bytes) break;
      video::Mpeg4Decoder probe;
      r = probe.configure(bytes, size_t(s.size), &msg);
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

// The seconds the RGB reads spent converting through the swscale rebuild
// (summed over the threads that read) and the frames they converted since
// the last reset; ``reset`` sets both to 0 after reading them.
void dali_tpu_torch_sws_clock(int reset, double* seconds, long* frames) {
  *seconds = double(reset ? sws_ns.exchange(0) : sws_ns.load()) * 1e-9;
  *frames = long(reset ? sws_frames.exchange(0) : sws_frames.load());
}

}  // extern "C"
