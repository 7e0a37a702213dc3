// Batch entry of the int16 coefficient wire: file bytes -> the k x k
// low-frequency corner of every block at full int16 precision (luma ky x ky,
// chroma kc x kc, natural order) plus the two quantisation-table corners,
// written straight into each sample's slot of the padded boundary canvases.
// One call per batch, samples fanned out on the tasking pool.
//
// A libjpeg-free copy of dali_tpu_jpeg_read_coeffs
// (dali_tpu/native/src/jpeg_coeffs.cc): blocks past a component's real block
// extent are zero; a grayscale stream gets zero chroma planes and a chroma
// quantisation table of ones (Cb = Cr = 128 after the IDCT, so R = G = B =
// Y). A sample the full read declines is reported in `rcs` and the caller
// raises.

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <vector>

#include "jpeg_full.h"

extern "C" {
int64_t dali_tpu_task_submit(void*, void (*)(void*), void*, const int64_t*, int);
void dali_tpu_pool_wait_all(void*);
int dali_tpu_pool_num_threads(void*);
}

namespace {

struct CoefJob {
  const char* data;
  size_t len;
  int ky, kc;
  short* dst[3];  // Y, Cb, Cr slot origins
  long ld[3];     // block-row strides of the slots, in blocks
  int bh[3], bw[3];
  unsigned short* q;
  int* rc;
};

void run_coef_job(void* p) {
  CoefJob* j = static_cast<CoefJob*>(p);
  dali_tpu_torch::JpegFull f;
  *j->rc = dali_tpu_torch::jpeg_read_full(reinterpret_cast<const uint8_t*>(j->data), j->len, &f);
  if (*j->rc == 0 && !f.wire_form()) *j->rc = 1;  // the wire carries YCbCr and grayscale only
  if (*j->rc != 0) return;
  for (int c = 0; c < 3; c++) {
    const int k = c == 0 ? j->ky : j->kc;
    const bool have = c < f.ncomp;
    for (int br = 0; br < j->bh[c]; br++)
      for (int bc = 0; bc < j->bw[c]; bc++) {
        short* o = j->dst[c] + ((long)br * j->ld[c] + bc) * k * k;
        if (!have || br >= f.bh[c] || bc >= f.bw[c]) {
          std::memset(o, 0, sizeof(short) * k * k);
          continue;
        }
        const short* b = f.coef[c].data() + ((size_t)br * f.bw[c] + bc) * 64;
        for (int r = 0; r < k; r++)
          for (int cc = 0; cc < k; cc++) o[r * k + cc] = b[r * 8 + cc];
      }
  }
  for (int c = 0; c < 2; c++) {
    const int k = c == 0 ? j->ky : j->kc;
    unsigned short* qd = j->q + (c == 0 ? 0 : j->ky * j->ky);
    for (int r = 0; r < k; r++)
      for (int cc = 0; cc < k; cc++) qd[r * k + cc] = c < f.ncomp ? f.q[c][r * 8 + cc] : 1;
  }
}

}  // namespace

// Sample i's planes go to y_dst[i] (block-row stride y_ld), cb_dst[i] and
// cr_dst[i] (stride c_ld), over ybh[i] x ybw[i] and cbh[i] x cbw[i] blocks;
// its tables to q + i*(ky²+kc²). rcs[i] = 0 when read. A null pool, or one
// of one thread, runs the samples inline.
extern "C" int dali_tpu_torch_coef_full_batch(
    void* pool, const char** datas, const size_t* lens, int n, int ky, int kc,
    short** y_dst, long y_ld, short** cb_dst, short** cr_dst, long c_ld, const int* ybh,
    const int* ybw, const int* cbh, const int* cbw, unsigned short* q, int* rcs) {
  std::vector<CoefJob> jobs(n);
  const bool inline_run = pool == nullptr || dali_tpu_pool_num_threads(pool) <= 1;
  const int qn = ky * ky + kc * kc;
  for (int i = 0; i < n; i++) {
    jobs[i] = {datas[i], lens[i], ky, kc, {y_dst[i], cb_dst[i], cr_dst[i]},
               {y_ld, c_ld, c_ld}, {ybh[i], cbh[i], cbh[i]}, {ybw[i], cbw[i], cbw[i]},
               q + (long)i * qn, &rcs[i]};
    if (inline_run) run_coef_job(&jobs[i]);
    else dali_tpu_task_submit(pool, run_coef_job, &jobs[i], nullptr, 0);
  }
  if (!inline_run) dali_tpu_pool_wait_all(pool);
  return 0;
}
