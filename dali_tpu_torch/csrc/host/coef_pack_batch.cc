// Batch entry of the hybrid-JPEG host half: file bytes -> sparse coefficient
// wire, one call per batch, samples fanned out on the tasking pool.
//
// A libjpeg-free copy of dali_tpu_jpeg_coeffs_split_flat_crop_pack_batch
// (dali_tpu/native/src/jpeg_coeffs_split.cc). Each sample goes through the
// from-scratch baseline decoder (jpeg_huff.cc ..._crop_pack_idx), which emits
// the zigzag-convention bitmaps + contiguous value streams directly; a stream
// it declines goes into dense scratch planes and is compacted into the same
// convention: SOF2 through the progressive decoder, grayscale through the
// dense baseline read (zero chroma planes, chroma quant table of 1s, as the
// reference's libjpeg fallback writes them), and what both decline
// (progressive grayscale, one scan per component) through the full read. A
// sample none of them reads is reported in `oks` and the caller raises.

#include <cstdint>
#include <cstring>
#include <initializer_list>
#include <vector>

extern "C" {
int64_t dali_tpu_task_submit(void*, void (*)(void*), void*, const int64_t*,
                             int);
void dali_tpu_pool_wait_all(void*);
int dali_tpu_pool_num_threads(void*);
int dali_tpu_jpeg_huff_read_coeffs_split_crop_pack_idx(
    const char*, size_t, int, int, short*, unsigned short*, signed char*,
    long long*, short*, short*, unsigned short*, signed char*, long long*,
    unsigned short*, int, int, int, int, int, int, int, int, unsigned char*,
    long long);
int dali_tpu_jpeg_huff_progressive_read_coeffs_split_crop(
    const char*, size_t, int, int, short*, signed char*, short*, signed char*,
    short*, signed char*, unsigned short*, int, int, int, int, int, int, int,
    int);
int dali_tpu_jpeg_huff_read_coeffs_split_crop(
    const char*, size_t, int, int, short*, signed char*, short*, signed char*,
    short*, signed char*, unsigned short*, int, int, int, int, int, int, int,
    int);
int dali_tpu_torch_jpeg_full_read_coeffs_split_crop(
    const char*, size_t, int, int, short*, signed char*, short*, signed char*,
    short*, signed char*, unsigned short*, int, int, int, int, int, int, int,
    int);
long long dali_tpu_sparse_pack_i8_perm(const signed char*, long long, int,
                                       const unsigned char*, unsigned short*,
                                       signed char*);
}

namespace {

// b-th selected coefficient in zigzag order -> slot (r*k + c - 1)
void zz_perm(int k, unsigned char* perm /*[16]*/) {
  std::memset(perm, 0x80, 16);
  int r = 0, c = 0, b = 0;
  for (int z = 0; z < 64; z++) {
    if (z > 0 && r < k && c < k) perm[b++] = (unsigned char)(r * k + c - 1);
    if (((r + c) & 1) == 0) {
      if (c == 7) r++;
      else if (r == 0) c++;
      else { r--; c++; }
    } else {
      if (r == 7) c++;
      else if (c == 0) r++;
      else { r++; c--; }
    }
  }
}

struct PackJob {
  const char* data;
  size_t len;
  int ky, kc, bh, bw, cbh, cbw;
  int y_br0, y_bc0, c_br0, c_bc0;
  short* y_dc;
  short* cb_dc;
  short* cr_dc;
  unsigned short* y_mask;
  signed char* y_vals;
  unsigned short* c_mask;
  signed char* c_vals;
  unsigned short* q;
  long long* y_nnz;
  long long* c_nnz;
  int* ok;
  const unsigned char* perm_y;
  const unsigned char* perm_c;
  unsigned char* idx;  // per-file ROI decode index blob (nullable)
  long long idx_cap;
};

void run_pack_job(void* p) {
  PackJob* j = static_cast<PackJob*>(p);
  int rc = dali_tpu_jpeg_huff_read_coeffs_split_crop_pack_idx(
      j->data, j->len, j->ky, j->kc, j->y_dc, j->y_mask, j->y_vals, j->y_nnz,
      j->cb_dc, j->cr_dc, j->c_mask, j->c_vals, j->c_nnz, j->q, j->bh, j->bw,
      j->cbh, j->cbw, j->y_br0, j->y_bc0, j->c_br0, j->c_bc0, j->idx,
      j->idx_cap);
  if (rc != 0) {
    const int nac_y = j->ky * j->ky - 1, nac_c = j->kc * j->kc - 1;
    const long y_n = (long)j->bh * j->bw;
    const long c_n = (long)j->cbh * j->cbw;
    thread_local std::vector<signed char> y_s, cb_s, cr_s;
    if ((long)y_s.size() < y_n * nac_y + 16) y_s.resize(y_n * nac_y + 16);
    if ((long)cb_s.size() < c_n * nac_c + 16) cb_s.resize(c_n * nac_c + 16);
    if ((long)cr_s.size() < c_n * nac_c + 16) cr_s.resize(c_n * nac_c + 16);
    for (auto read : {dali_tpu_jpeg_huff_progressive_read_coeffs_split_crop,
                      dali_tpu_jpeg_huff_read_coeffs_split_crop,
                      dali_tpu_torch_jpeg_full_read_coeffs_split_crop}) {
      rc = read(j->data, j->len, j->ky, j->kc, j->y_dc, y_s.data(), j->cb_dc,
                cb_s.data(), j->cr_dc, cr_s.data(), j->q, j->bh, j->bw, j->cbh,
                j->cbw, j->y_br0, j->y_bc0, j->c_br0, j->c_bc0);
      if (rc == 0) break;
    }
    if (rc == 0) {
      *j->y_nnz = dali_tpu_sparse_pack_i8_perm(y_s.data(), y_n, nac_y,
                                               j->perm_y, j->y_mask,
                                               j->y_vals);
      long long cb = dali_tpu_sparse_pack_i8_perm(cb_s.data(), c_n, nac_c,
                                                  j->perm_c, j->c_mask,
                                                  j->c_vals);
      long long cr = dali_tpu_sparse_pack_i8_perm(
          cr_s.data(), c_n, nac_c, j->perm_c, j->c_mask + c_n,
          j->c_vals + cb);
      *j->c_nnz = cb + cr;
    }
  }
  *j->ok = rc == 0 ? 1 : 0;
}

}  // namespace

// Same argument layout as the reference batch entry. Value streams are
// decoded at worst-case offsets and compacted into one contiguous stream per
// plane afterwards (totals in y_total / c_total).
extern "C" int dali_tpu_torch_coef_pack_batch(
    void* pool, const char** datas, const size_t* lens, int n, int ky, int kc,
    const int* ybh, const int* ybw, const int* cbh, const int* cbw,
    const int* y_br0, const int* y_bc0, const int* c_br0, const int* c_bc0,
    const long* y_dc_off, const long* y_ac_off, const long* c_dc_off,
    const long* c_ac_off, short* y_dc, unsigned short* y_mask,
    signed char* y_vals, short* c_dc, unsigned short* c_mask,
    signed char* c_vals, unsigned short* q, int* oks, long long* y_total,
    long long* c_total, unsigned char** idxs, const long long* idx_caps) {
  const int qn = ky * ky + kc * kc;
  unsigned char perm_y[16], perm_c[16];
  zz_perm(ky, perm_y);
  zz_perm(kc, perm_c);
  std::vector<PackJob> jobs(n);
  std::vector<long long> y_nnz(n), c_nnz(n);
  const bool inline_run = dali_tpu_pool_num_threads(pool) <= 1;
  for (int i = 0; i < n; i++) {
    const long c_n = (long)cbh[i] * cbw[i];
    jobs[i] = {datas[i],      lens[i],
               ky,            kc,
               ybh[i],        ybw[i],
               cbh[i],        cbw[i],
               y_br0[i],      y_bc0[i],
               c_br0[i],      c_bc0[i],
               y_dc + y_dc_off[i],
               c_dc + c_dc_off[i],
               c_dc + c_dc_off[i] + c_n,
               y_mask + y_dc_off[i],
               y_vals + y_ac_off[i],
               c_mask + c_dc_off[i],
               c_vals + c_ac_off[i],
               q + (long)i * qn,
               &y_nnz[i],     &c_nnz[i],
               &oks[i],       perm_y,
               perm_c,
               idxs ? idxs[i] : nullptr,
               idxs && idx_caps ? idx_caps[i] : 0};
    if (inline_run) run_pack_job(&jobs[i]);
    else dali_tpu_task_submit(pool, run_pack_job, &jobs[i], nullptr, 0);
  }
  if (!inline_run) dali_tpu_pool_wait_all(pool);
  // dst <= src throughout, so a forward memmove in sample order is safe
  long long yt = 0, ct = 0;
  for (int i = 0; i < n; i++) {
    if (!oks[i]) continue;
    if (yt != y_ac_off[i]) std::memmove(y_vals + yt, y_vals + y_ac_off[i], y_nnz[i]);
    yt += y_nnz[i];
    if (ct != c_ac_off[i]) std::memmove(c_vals + ct, c_vals + c_ac_off[i], c_nnz[i]);
    ct += c_nnz[i];
  }
  *y_total = yt;
  *c_total = ct;
  return 0;
}
