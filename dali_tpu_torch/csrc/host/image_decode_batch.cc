// C entry points of the WebP, TIFF and PNM decoders (webp_decode.cc,
// tiff_decode.cc, pnm_decode.cc), one sample at a time and a batch on the
// operator's task pool (tasking.cc): one call per batch, each sample a task,
// the GIL released by ctypes for the call's length.

#include <cstddef>
#include <cstdint>
#include <vector>

namespace dali_webp {
int webp_info(const uint8_t* data, size_t len, int* h, int* w, int* orientation);
int webp_decode(const uint8_t* data, size_t len, int gray, uint8_t* dst);
int webp_alpha(const uint8_t* data, size_t len, uint8_t* dst);
}  // namespace dali_webp
namespace dali_tiff {
int info(const uint8_t* data, size_t len, int* h, int* w, int* orientation, int* depth,
         int* n_chunks);
int chunks(const uint8_t* data, size_t len, int n, uint64_t* offsets, uint64_t* counts,
           uint64_t* sizes);
int decode(const uint8_t* data, size_t len, int gray, void* dst);
}  // namespace dali_tiff
namespace dali_pnm {
int info(const uint8_t* data, size_t len, int* h, int* w, int* depth);
int decode(const uint8_t* data, size_t len, int gray, void* dst);
}  // namespace dali_pnm

extern "C" {
int64_t dali_tpu_task_submit(void* pool, void (*fn)(void*), void* arg, const int64_t* deps,
                             int ndeps);
int dali_tpu_pool_num_threads(void* pool);
void dali_tpu_pool_wait_all(void* pool);
}

namespace {

enum Kind { kWebp = 0, kTiff = 1, kPnm = 2 };

struct Job {
  const uint8_t* data;
  size_t len;
  int kind, gray;
  void* dst;
  int* rc;
};

int run(const Job& j) {
  switch (j.kind) {
    case kWebp: return dali_webp::webp_decode(j.data, j.len, j.gray, static_cast<uint8_t*>(j.dst));
    case kTiff: return dali_tiff::decode(j.data, j.len, j.gray, j.dst);
    case kPnm: return dali_pnm::decode(j.data, j.len, j.gray, j.dst);
    default: return -1;
  }
}

void run_job(void* arg) {
  Job* j = static_cast<Job*>(arg);
  *j->rc = run(*j);
}

}  // namespace

extern "C" {

// (h, w) and the EXIF orientation of a WebP; 0, -1 for a file cv2 rejects,
// 1 for an animation the decoder does not read.
int dali_tpu_torch_webp_info(const uint8_t* data, size_t len, int* h, int* w, int* orientation) {
  return dali_webp::webp_info(data, len, h, w, orientation);
}

// (h, w), Orientation, output depth (0 uint8, 1 uint16, 2 float32) and the
// number of strips or tiles; 0, -1 or 1 (a form not read).
int dali_tpu_torch_tiff_info(const uint8_t* data, size_t len, int* h, int* w, int* orientation,
                             int* depth, int* n_chunks) {
  return dali_tiff::info(data, len, h, w, orientation, depth, n_chunks);
}

// The alpha plane [h, w] of a still lossy WebP's ALPH chunk: 0, -1 (libwebp
// fails it) or 1 (no such chunk).
int dali_tpu_torch_webp_alpha(const uint8_t* data, size_t len, uint8_t* dst) {
  return dali_webp::webp_alpha(data, len, dst);
}

int dali_tpu_torch_tiff_chunks(const uint8_t* data, size_t len, int n, uint64_t* offsets,
                               uint64_t* counts, uint64_t* sizes) {
  return dali_tiff::chunks(data, len, n, offsets, counts, sizes);
}

// (h, w) and output depth (0 uint8, 1 uint16); 0 or -1.
int dali_tpu_torch_pnm_info(const uint8_t* data, size_t len, int* h, int* w, int* depth) {
  return dali_pnm::info(data, len, h, w, depth);
}

// Decode ``n`` samples, ``kinds[i]`` 0 WebP, 1 TIFF, 2 PNM, each into
// ``dsts[i]`` (C-contiguous [h, w, 3] RGB, or [h, w, 1] with ``gray``, in
// the depth the info call gave). ``rcs[i]``: 0, -1 (corrupt) or 1 (a form
// not read).
int dali_tpu_torch_image_decode_batch(void* pool, const char** datas, const size_t* lens, int n,
                                      const int* kinds, int gray, void** dsts, int* rcs) {
  std::vector<Job> jobs(n);
  const bool inline_run = pool == nullptr || dali_tpu_pool_num_threads(pool) <= 1;
  for (int i = 0; i < n; i++) {
    jobs[i] = {reinterpret_cast<const uint8_t*>(datas[i]), lens[i], kinds[i], gray, dsts[i],
               &rcs[i]};
    if (inline_run) run_job(&jobs[i]);
    else dali_tpu_task_submit(pool, run_job, &jobs[i], nullptr, 0);
  }
  if (!inline_run) dali_tpu_pool_wait_all(pool);
  return 0;
}

}  // extern "C"
