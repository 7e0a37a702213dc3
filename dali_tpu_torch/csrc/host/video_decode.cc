// Frame-accurate video reads over the MP4 demuxer and the MPEG-4 Part 2
// decoder: the counterpart of dali_tpu's FFmpeg-backed video_decode.cc,
// with its contract:
//   * fps is the track's average frame rate (25 when it is not positive),
//     the frame count the stts count;
//   * a decoded picture's frame index is its pts in seconds times fps plus
//     0.5, truncated;
//   * a read seeks when its first frame lies behind the decoder or more
//     than 64 frames ahead of it: to the last sync sample at or before the
//     target's timestamp, then decodes forward, dropping frames before it;
//   * after the last sample the reader stays at its end until it seeks;
//   * RGB is the framework's integer BT.601 with nearest chroma; the planar
//     read copies the 4:2:0 planes;
//   * a picture whose size differs from the size at open (an in-band VOL
//     header that changes it) ends an RGB read as the end of the stream
//     does, and fails a planar read with -2 - got, as the reference's
//     dimension check does.
// A frame reached by seeking and the same frame reached by decoding forward
// are the same bytes: every decode starts from a sync sample.
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

#include <climits>
#include <cmath>
#include <cstdio>
#include <cstring>
#include <string>
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

struct VideoHandle {
  std::vector<uint8_t> data;  // the file's bytes, when opened from memory
  int fd = -1;                // the file, when opened from a path
  uint64_t size = 0;          // the file's size
  std::vector<uint8_t> sample;  // the bytes of the sample being decoded (fd)
  video::Track track;
  video::Mpeg4Decoder dec;
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

// Decodes up to the next picture; returns its frame index, kEof, kDamaged
// or kUnsupportedRead.
int64_t decode_next(VideoHandle* v) {
  while (true) {
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
    std::string msg;
    int r = v->dec.decode(bytes, size, &msg);
    if (r == 1 && !s.discard) {
      int64_t idx = pts_to_frame(v, s.pts);
      v->next_frame = idx + 1;
      return idx;
    }
    if (r < 0) {
      v->error = msg;
      return r == video::kUnsupported ? kUnsupportedRead : kDamaged;
    }
  }
}

void seek_if_needed(VideoHandle* v, long target) {
  if (!(target < v->next_frame || target > v->next_frame + 64)) return;
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

bool size_changed(const VideoHandle* v, const video::Picture& p) {
  return p.width != v->width || p.height != v->height;
}

int read_rgb(VideoHandle* v, long start, int count, int stride, unsigned char* out) {
  long target = start;
  int got = 0;
  seek_if_needed(v, target);
  const size_t frame_bytes = (size_t)v->width * v->height * 3;
  while (got < count) {
    int64_t idx = decode_next(v);
    if (idx < 0) return finish(got, idx);
    if (idx >= target) {
      if (size_changed(v, v->dec.picture())) return finish(got, kEof);
      picture_to_rgb(v->dec.picture(), v->width, v->height, v->dec.full_range(),
                     out + (size_t)got * frame_bytes);
      got++;
      target += stride;
    }
  }
  return got;
}

int read_yuv(VideoHandle* v, long start, int count, int stride, unsigned char* oy,
             unsigned char* ou, unsigned char* ov) {
  long target = start;
  int got = 0;
  seek_if_needed(v, target);
  const int w = v->width, h = v->height, cw = (w + 1) / 2, ch = (h + 1) / 2;
  while (got < count) {
    int64_t idx = decode_next(v);
    if (idx < 0) return finish(got, idx);
    if (idx >= target) {
      const video::Picture& p = v->dec.picture();
      if (size_changed(v, p)) return -2 - got;
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

}  // namespace

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
    r = video::demux_mp4_fd(v->fd, v->size, &v->track, &msg);
  } else {
    v->data.assign(data, data + n);
    v->size = n;
    r = video::demux_mp4(v->data.data(), v->data.size(), &v->track, &msg);
  }
  if (r != video::kOk) return fail(r == video::kUnsupported ? 2 : 1, msg);
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

// 1 = 4:2:0 limited range, 2 = 4:2:0 full range (the VO header's video_range)
int dali_tpu_torch_video_pixfmt_class(void* handle) {
  auto* v = static_cast<VideoHandle*>(handle);
  if (!v) return 0;
  return v->dec.full_range() ? 2 : 1;
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

}  // extern "C"
