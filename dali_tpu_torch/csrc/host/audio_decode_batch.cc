// The batch entry of the FLAC, MP3 and Ogg Vorbis decoders: n streams, each
// on a worker of the task pool.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <new>
#include <vector>

#include "audio_codecs.h"

extern "C" int64_t dali_tpu_task_submit(void*, void (*)(void*), void*, const int64_t*, int);
extern "C" void dali_tpu_pool_wait_all(void*);
extern "C" int dali_tpu_pool_num_threads(void*);

namespace {

constexpr int kCodecMp3 = 1;
constexpr int kCodecVorbis = 2;
constexpr int kCodecFlac = 3;

struct Job {
  const uint8_t* data;
  size_t len;
  int codec;
  float** out;
  long long* frames;
  int* channels;
  double* rate;
  int* rc;
};

void run_job(void* p) {
  Job* j = static_cast<Job*>(p);
  *j->out = nullptr;
  try {
    audio_codecs::Pcm pcm;
    *j->rc = j->codec == kCodecMp3      ? audio_codecs::mp3_decode(j->data, j->len, pcm)
             : j->codec == kCodecVorbis ? audio_codecs::vorbis_decode(j->data, j->len, pcm)
             : j->codec == kCodecFlac   ? audio_codecs::flac_decode(j->data, j->len, pcm)
                                        : audio_codecs::kUnsupported;
    if (*j->rc != audio_codecs::kOk) return;
    float* buf = static_cast<float*>(std::malloc(pcm.samples.size() * sizeof(float)));
    if (!buf) {
      *j->rc = audio_codecs::kNoMemory;
      return;
    }
    std::memcpy(buf, pcm.samples.data(), pcm.samples.size() * sizeof(float));
    *j->out = buf;
    *j->frames = static_cast<long long>(pcm.samples.size() / pcm.channels);
    *j->channels = pcm.channels;
    *j->rate = static_cast<double>(pcm.rate);
  } catch (const std::bad_alloc&) {
    *j->rc = audio_codecs::kNoMemory;
  }
}

}  // namespace

extern "C" {

void dali_tpu_torch_audio_free(float* p) { std::free(p); }

// Decode n streams, codecs[i] 1 (MP3), 2 (Ogg Vorbis) or 3 (FLAC), each into a
// malloc'd interleaved float32 buffer (freed with dali_tpu_torch_audio_free).
// rcs[i]: 0 decoded, -1 malformed (or, FLAC, failing a CRC), -2 a form not
// decoded, -3 out of memory.
// A null pool, or one of one thread, decodes inline.
int dali_tpu_torch_audio_decode_batch(void* pool, const char** datas, const size_t* lens,
                                      const int* codecs, int n, float** outs,
                                      long long* frames, int* channels, double* rates,
                                      int* rcs) {
  std::vector<Job> jobs(n);
  const bool inline_run = pool == nullptr || dali_tpu_pool_num_threads(pool) <= 1;
  for (int i = 0; i < n; i++) {
    jobs[i] = {reinterpret_cast<const uint8_t*>(datas[i]), lens[i], codecs[i], &outs[i],
               &frames[i], &channels[i], &rates[i], &rcs[i]};
    if (inline_run) run_job(&jobs[i]);
    else dali_tpu_task_submit(pool, run_job, &jobs[i], nullptr, 0);
  }
  if (!inline_run) dali_tpu_pool_wait_all(pool);
  return 0;
}

}  // extern "C"
