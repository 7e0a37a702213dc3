// Batch entry of the hybrid-JPEG host half: file bytes -> dense coefficient
// planes (DC int16, AC saturated to int8), one call per batch, samples fanned
// out on the tasking pool. The coefficient cache stores these planes, and the
// wire is packed from them afterwards (sparse_pack.cc dali_tpu_pack_wire).
//
// A libjpeg-free copy of dali_tpu_jpeg_coeffs_split_flat_crop_batch
// (dali_tpu/native/src/jpeg_coeffs_split.cc), which also serves the
// whole-image read of dali_tpu_jpeg_coeffs_split_flat_batch with zero block
// origins. Each sample goes through the from-scratch baseline decoder
// (jpeg_huff.cc ..._read_coeffs_split_crop); a stream it declines (SOF2) goes
// through the progressive decoder with the same contract, and one both
// decline (progressive grayscale, one scan per component) through the full
// read, where the reference falls back to libjpeg. A sample none of them
// reads is reported in `oks` and the caller raises.

#include <cstddef>
#include <cstdint>
#include <initializer_list>
#include <vector>

extern "C" {
int64_t dali_tpu_task_submit(void*, void (*)(void*), void*, const int64_t*,
                             int);
void dali_tpu_pool_wait_all(void*);
int dali_tpu_pool_num_threads(void*);
int dali_tpu_jpeg_huff_read_coeffs_split_crop(const char*, size_t, int, int,
                                              short*, signed char*, short*,
                                              signed char*, short*,
                                              signed char*, unsigned short*,
                                              int, int, int, int, int, int,
                                              int, int);
int dali_tpu_jpeg_huff_progressive_read_coeffs_split_crop(
    const char*, size_t, int, int, short*, signed char*, short*, signed char*,
    short*, signed char*, unsigned short*, int, int, int, int, int, int, int,
    int);
int dali_tpu_torch_jpeg_full_read_coeffs_split_crop(
    const char*, size_t, int, int, short*, signed char*, short*, signed char*,
    short*, signed char*, unsigned short*, int, int, int, int, int, int, int,
    int);
}

namespace {

struct DenseJob {
  const char* data;
  size_t len;
  int ky, kc, bh, bw, cbh, cbw;
  int y_br0, y_bc0, c_br0, c_bc0;
  short* y_dc;
  signed char* y_ac;
  short* cb_dc;
  signed char* cb_ac;
  short* cr_dc;
  signed char* cr_ac;
  unsigned short* q;
  int* ok;
};

void run_dense_job(void* p) {
  DenseJob* j = static_cast<DenseJob*>(p);
  int rc = dali_tpu_jpeg_huff_read_coeffs_split_crop(
      j->data, j->len, j->ky, j->kc, j->y_dc, j->y_ac, j->cb_dc, j->cb_ac,
      j->cr_dc, j->cr_ac, j->q, j->bh, j->bw, j->cbh, j->cbw, j->y_br0,
      j->y_bc0, j->c_br0, j->c_bc0);
  for (auto read : {dali_tpu_jpeg_huff_progressive_read_coeffs_split_crop,
                    dali_tpu_torch_jpeg_full_read_coeffs_split_crop}) {
    if (rc == 0) break;
    rc = read(j->data, j->len, j->ky, j->kc, j->y_dc, j->y_ac, j->cb_dc, j->cb_ac, j->cr_dc,
              j->cr_ac, j->q, j->bh, j->bw, j->cbh, j->cbw, j->y_br0, j->y_bc0, j->c_br0,
              j->c_bc0);
  }
  *j->ok = rc == 0 ? 1 : 0;
}

}  // namespace

// Same argument layout as the reference's flat crop batch entry: per-sample
// window extents (ybh, ybw, cbh, cbw) and block origins, planes written
// densely at the given element offsets of four flat buffers.
extern "C" int dali_tpu_torch_coef_dense_batch(
    void* pool, const char** datas, const size_t* lens, int n, int ky, int kc,
    const int* ybh, const int* ybw, const int* cbh, const int* cbw,
    const int* y_br0, const int* y_bc0, const int* c_br0, const int* c_bc0,
    const long* y_dc_off, const long* y_ac_off, const long* c_dc_off,
    const long* c_ac_off, short* y_dc, signed char* y_ac, short* c_dc,
    signed char* c_ac, unsigned short* q, int* oks) {
  const int c_ac_k = kc * kc - 1;
  const int qn = ky * ky + kc * kc;
  std::vector<DenseJob> jobs(n);
  const bool inline_run = dali_tpu_pool_num_threads(pool) <= 1;
  for (int i = 0; i < n; i++) {
    const long c_n = (long)cbh[i] * cbw[i];
    jobs[i] = {datas[i],
               lens[i],
               ky,
               kc,
               ybh[i],
               ybw[i],
               cbh[i],
               cbw[i],
               y_br0[i],
               y_bc0[i],
               c_br0[i],
               c_bc0[i],
               y_dc + y_dc_off[i],
               y_ac + y_ac_off[i],
               c_dc + c_dc_off[i],
               c_ac + c_ac_off[i],
               c_dc + c_dc_off[i] + c_n,
               c_ac + c_ac_off[i] + c_n * c_ac_k,
               q + (long)i * qn,
               &oks[i]};
    if (inline_run) run_dense_job(&jobs[i]);
    else dali_tpu_task_submit(pool, run_dense_job, &jobs[i], nullptr, 0);
  }
  if (!inline_run) dali_tpu_pool_wait_all(pool);
  return 0;
}
