// Sparse wire packing for the hybrid JPEG decoder's AC planes.
//
// Quantized AC coefficients are mostly zero (q85 photographic content keeps
// ~4-7 nonzeros of the 15 low-frequency slots per block), yet the flat wire
// shipped all k*k-1 of them densely — 75% of host→device bytes. This pass
// compacts a dense per-block int8 plane into:
//   * mask: one uint16 per block, bit j set iff slot j is nonzero (block
//     order identical to the DC plane's flat layout), and
//   * vals: the nonzero int8 values, concatenated in slot order across all
//     blocks of the whole batch (self-describing: the device program
//     rebuilds positions from cumsum(popcount(mask)) — no offsets shipped).
//
// The device reconstruction lives in executor.py::_unsparse_boundary.
// Reference analogue: the nvJPEG hybrid wire also ships entropy-compacted
// coefficients rather than dense planes.
//
// SSSE3 path: one 16-byte load per block, pcmpeqb+movemask for the bitmap,
// two pshufb table-compactions (classic left-pack) for the values. Caller
// must size `vals` for worst case (n_blocks * nac) plus 16 slack bytes —
// each 8-byte store may overhang the current write position.

#include <cstdint>
#include <cstring>

#if defined(__SSSE3__)
#include <tmmintrin.h>
#endif

namespace {

struct CompTbl {
  alignas(16) uint8_t idx[256][8];
  uint8_t cnt[256];
  CompTbl() {
    for (int m = 0; m < 256; m++) {
      int t = 0;
      for (int b = 0; b < 8; b++)
        if (m >> b & 1) idx[m][t++] = (uint8_t)b;
      cnt[m] = (uint8_t)t;
      for (; t < 8; t++) idx[m][t] = 0x80;  // pshufb: high bit -> zero
    }
  }
};
const CompTbl kTbl;

}  // namespace

extern "C" {

// Returns the total number of packed values (== sum of popcounts of mask).
// nac must be <= 16 (one uint16 bitmap per block); callers gate on that.
long long dali_tpu_sparse_pack_i8(const signed char* dense, long long n_blocks,
                                  int nac, unsigned short* mask,
                                  signed char* vals) {
  if (nac < 1 || nac > 16) return -1;
  const unsigned lim = nac >= 16 ? 0xFFFFu : ((1u << nac) - 1);
  long long t = 0;
  long long b = 0;
#if defined(__SSSE3__)
  // blocks whose 16-byte load stays inside the dense buffer
  const long long n_sse =
      n_blocks - ((16 + nac - 1) / nac);  // conservative tail
  const __m128i zero = _mm_setzero_si128();
  const __m128i eight = _mm_set1_epi8(8);
  for (; b < n_sse; b++) {
    __m128i v = _mm_loadu_si128(
        reinterpret_cast<const __m128i*>(dense + b * nac));
    unsigned zm = (unsigned)_mm_movemask_epi8(_mm_cmpeq_epi8(v, zero));
    unsigned nz = ~zm & lim;
    mask[b] = (unsigned short)nz;
    unsigned mlo = nz & 0xFF, mhi = (nz >> 8) & 0xFF;
    __m128i slo =
        _mm_loadl_epi64(reinterpret_cast<const __m128i*>(kTbl.idx[mlo]));
    _mm_storel_epi64(reinterpret_cast<__m128i*>(vals + t),
                     _mm_shuffle_epi8(v, slo));
    t += kTbl.cnt[mlo];
    __m128i shi = _mm_add_epi8(
        _mm_loadl_epi64(reinterpret_cast<const __m128i*>(kTbl.idx[mhi])),
        eight);  // 0x80 stays >= 0x80 after +8, still zeroing
    _mm_storel_epi64(reinterpret_cast<__m128i*>(vals + t),
                     _mm_shuffle_epi8(v, shi));
    t += kTbl.cnt[mhi];
  }
#endif
  for (; b < n_blocks; b++) {
    const signed char* src = dense + b * nac;
    unsigned nz = 0;
    for (int j = 0; j < nac; j++)
      if (src[j]) {
        nz |= 1u << j;
        vals[t++] = src[j];
      }
    mask[b] = (unsigned short)nz;
  }
  return t;
}

// Permuted variant: bit b of the mask is coefficient perm[b] of the dense
// block (perm is uint8[16], entries past nac = 0x80). Used to pack
// libjpeg-decoded dense planes in the ZIGZAG-bit convention the pack-emit
// decoder produces (jpeg_huff.cc ..._crop_pack), so mixed fast/fallback
// batches share one wire convention.
long long dali_tpu_sparse_pack_i8_perm(const signed char* dense,
                                       long long n_blocks, int nac,
                                       const unsigned char* perm,
                                       unsigned short* mask,
                                       signed char* vals) {
  if (nac < 1 || nac > 16) return -1;
  const unsigned lim = nac >= 16 ? 0xFFFFu : ((1u << nac) - 1);
  long long t = 0;
  long long b = 0;
#if defined(__SSSE3__)
  const long long n_sse = n_blocks - ((16 + nac - 1) / nac);
  const __m128i zero = _mm_setzero_si128();
  const __m128i eight = _mm_set1_epi8(8);
  const __m128i pv =
      _mm_loadu_si128(reinterpret_cast<const __m128i*>(perm));
  for (; b < n_sse; b++) {
    __m128i v0 = _mm_loadu_si128(
        reinterpret_cast<const __m128i*>(dense + b * nac));
    __m128i v = _mm_shuffle_epi8(v0, pv);  // zigzag order
    unsigned zm = (unsigned)_mm_movemask_epi8(_mm_cmpeq_epi8(v, zero));
    unsigned nz = ~zm & lim;
    mask[b] = (unsigned short)nz;
    unsigned mlo = nz & 0xFF, mhi = (nz >> 8) & 0xFF;
    __m128i slo =
        _mm_loadl_epi64(reinterpret_cast<const __m128i*>(kTbl.idx[mlo]));
    _mm_storel_epi64(reinterpret_cast<__m128i*>(vals + t),
                     _mm_shuffle_epi8(v, slo));
    t += kTbl.cnt[mlo];
    __m128i shi = _mm_add_epi8(
        _mm_loadl_epi64(reinterpret_cast<const __m128i*>(kTbl.idx[mhi])),
        eight);
    _mm_storel_epi64(reinterpret_cast<__m128i*>(vals + t),
                     _mm_shuffle_epi8(v, shi));
    t += kTbl.cnt[mhi];
  }
#endif
  for (; b < n_blocks; b++) {
    const signed char* src = dense + b * nac;
    unsigned nz = 0;
    for (int j = 0; j < nac; j++) {
      signed char v = src[perm[j]];
      if (v) {
        nz |= 1u << j;
        vals[t++] = v;
      }
    }
    mask[b] = (unsigned short)nz;
  }
  return t;
}

// Nibble-pack a packed int8 value stream: each value becomes a signed
// 4-bit code in [-7, 7]; -8 (0x8) marks an escape whose full int8 value is
// appended to `escapes` in order. Self-describing like the mask stream —
// the device rebuilds escape positions from cumsum(code == -8). Two codes
// per output byte, little-nibble first; odd tail padded with 0.
// Returns the escape count. `escapes` must hold n + 16 bytes (worst case
// plus SIMD left-pack store slack).
long long dali_tpu_nib_pack_i8(const signed char* vals, long long n,
                               unsigned char* nibbles, signed char* escapes) {
  long long e = 0;
  long long i = 0;
#if defined(__SSSE3__)
  const __m128i lo7 = _mm_set1_epi8(7);
  const __m128i hi7 = _mm_set1_epi8(-7);
  const __m128i x0f = _mm_set1_epi8(0x0F);
  const __m128i x08 = _mm_set1_epi8(0x08);
  const __m128i evens =
      _mm_setr_epi8(0, 2, 4, 6, 8, 10, 12, 14, -1, -1, -1, -1, -1, -1, -1, -1);
  const __m128i odds =
      _mm_setr_epi8(1, 3, 5, 7, 9, 11, 13, 15, -1, -1, -1, -1, -1, -1, -1, -1);
  for (; i + 16 <= n; i += 16) {
    __m128i v = _mm_loadu_si128(reinterpret_cast<const __m128i*>(vals + i));
    __m128i esc = _mm_or_si128(_mm_cmpgt_epi8(v, lo7), _mm_cmpgt_epi8(hi7, v));
    __m128i nib = _mm_or_si128(_mm_andnot_si128(esc, _mm_and_si128(v, x0f)),
                               _mm_and_si128(esc, x08));
    __m128i ev = _mm_shuffle_epi8(nib, evens);
    __m128i od = _mm_shuffle_epi8(nib, odds);
    __m128i out = _mm_or_si128(ev, _mm_slli_epi16(_mm_and_si128(od, x0f), 4));
    _mm_storel_epi64(reinterpret_cast<__m128i*>(nibbles + (i >> 1)), out);
    unsigned em = (unsigned)_mm_movemask_epi8(esc);
    // compact escaped full values with the same two-level pshufb left-pack
    // as the block pack above (a scalar bit loop here costs ~5 ms/batch at
    // photo-content escape rates)
    unsigned mlo = em & 0xFF, mhi = (em >> 8) & 0xFF;
    __m128i slo =
        _mm_loadl_epi64(reinterpret_cast<const __m128i*>(kTbl.idx[mlo]));
    _mm_storel_epi64(reinterpret_cast<__m128i*>(escapes + e),
                     _mm_shuffle_epi8(v, slo));
    e += kTbl.cnt[mlo];
    __m128i shi = _mm_add_epi8(
        _mm_loadl_epi64(reinterpret_cast<const __m128i*>(kTbl.idx[mhi])),
        _mm_set1_epi8(8));
    _mm_storel_epi64(reinterpret_cast<__m128i*>(escapes + e),
                     _mm_shuffle_epi8(v, shi));
    e += kTbl.cnt[mhi];
  }
#endif
  unsigned char cur = 0;
  for (; i < n; i++) {
    int v = vals[i];
    unsigned nb;
    if (v < -7 || v > 7) {
      nb = 0x8;
      escapes[e++] = (signed char)v;
    } else {
      nb = (unsigned)v & 0xF;
    }
    if (i & 1) {
      nibbles[i >> 1] = (unsigned char)(cur | (nb << 4));
    } else {
      cur = (unsigned char)nb;
      if (i + 1 == n) nibbles[i >> 1] = cur;  // odd tail
    }
  }
  return e;
}

// Combined one-call wire pack (the per-primitive Python/ctypes round-trips
// cost more than the packing itself on 1-core hosts — ~4 ms of
// a 6.7 ms/batch section). Packs both AC planes (mask + nibble stream) and
// both DC planes (int8 + escapes) in ONE entry, with the escape streams
// written IN-PLACE into the front of their source buffers:
//   * AC escapes overwrite the packed-values temp (nib_pack reads vals[i]
//     and writes escapes[e] with e <= i; the SIMD chunk is loaded to
//     registers before any store, so the in-place prefix never clobbers
//     unread data),
//   * DC escapes go to the caller's (small, ring-recycled) escape buffers
//     exactly as the split per-primitive flow did.
// The four plane chains are independent; on multi-worker pools they run as
// tasks, single-worker pools run inline (tasking.cc pattern).
long long dali_tpu_sparse_pack_i8(const signed char*, long long, int,
                                  unsigned short*, signed char*);
long long dali_tpu_nib_pack_i8(const signed char*, long long, unsigned char*,
                               signed char*);
long long dali_tpu_esc_pack_i16(const short*, long long, signed char*, short*);
int64_t dali_tpu_task_submit(void*, void (*)(void*), void*, const int64_t*,
                             int);
void dali_tpu_pool_wait_all(void*);
int dali_tpu_pool_num_threads(void*);

long long dali_tpu_sparse_pack_i8_perm(const signed char*, long long, int,
                                       const unsigned char*, unsigned short*,
                                       signed char*);

namespace {

// zigzag selection permutation for a k*k-1 low-frequency selection:
// perm[b] = slot (r*k + c - 1) of the b-th selected coefficient in zigzag
// order (the wire's mask-bit convention; identical walk to jpeg_huff.cc).
void zz_sel_perm(int k, unsigned char* perm /*[16]*/) {
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

struct AcJob {
  const signed char* ac;
  long long n_blocks;
  int nac;
  unsigned short* mask;
  signed char* vals;
  unsigned char* nibs;
  long long* nnz_out;
  long long* esc_out;
};
void run_ac_job(void* p) {
  AcJob* j = static_cast<AcJob*>(p);
  // pack in the ZIGZAG-bit convention (nac = k*k-1 by construction), so
  // dense-plane batches and pack-emit decoder batches share one wire format
  int k = 1;
  while (k * k - 1 < j->nac) k++;
  unsigned char perm[16];
  zz_sel_perm(k, perm);
  long long nnz = dali_tpu_sparse_pack_i8_perm(j->ac, j->n_blocks, j->nac,
                                               perm, j->mask, j->vals);
  *j->nnz_out = nnz;
  *j->esc_out = dali_tpu_nib_pack_i8(j->vals, nnz, j->nibs, j->vals);
}
struct DcJob {
  const short* dc;
  long long n_blocks;
  long long dc_len;  // ratcheted plane length; tail past n_blocks zeroed
  signed char* dc8;
  short* esc16;
  long long* esc_out;
};
void run_dc_job(void* p) {
  DcJob* j = static_cast<DcJob*>(p);
  *j->esc_out = dali_tpu_esc_pack_i16(j->dc, j->n_blocks, j->dc8, j->esc16);
  if (j->dc_len > j->n_blocks)
    std::memset(j->dc8 + j->n_blocks, 0, (size_t)(j->dc_len - j->n_blocks));
}
}  // namespace

// counts[6]: y_nnz, y_val_esc, c_nnz, c_val_esc, y_dc_esc, c_dc_esc.
void dali_tpu_pack_wire(void* pool, const signed char* y_ac,
                        long long ny_blocks, int nac_y,
                        const signed char* c_ac, long long nc_blocks,
                        int nac_c, const short* y_dc, const short* c_dc,
                        long long y_dc_len, long long c_dc_len,
                        unsigned short* y_mask, unsigned char* y_nibs,
                        signed char* y_vals, unsigned short* c_mask,
                        unsigned char* c_nibs, signed char* c_vals,
                        signed char* y_dc8, short* y_esc16,
                        signed char* c_dc8, short* c_esc16,
                        long long* counts) {
  AcJob ya = {y_ac, ny_blocks, nac_y, y_mask, y_vals,
              y_nibs, &counts[0], &counts[1]};
  AcJob ca = {c_ac, nc_blocks, nac_c, c_mask, c_vals,
              c_nibs, &counts[2], &counts[3]};
  DcJob yd = {y_dc, ny_blocks, y_dc_len, y_dc8, y_esc16, &counts[4]};
  DcJob cd = {c_dc, nc_blocks, c_dc_len, c_dc8, c_esc16, &counts[5]};
  if (pool == nullptr || dali_tpu_pool_num_threads(pool) <= 1) {
    run_ac_job(&ya);
    run_ac_job(&ca);
    run_dc_job(&yd);
    run_dc_job(&cd);
  } else {
    dali_tpu_task_submit(pool, run_ac_job, &ya, nullptr, 0);
    dali_tpu_task_submit(pool, run_ac_job, &ca, nullptr, 0);
    dali_tpu_task_submit(pool, run_dc_job, &yd, nullptr, 0);
    dali_tpu_task_submit(pool, run_dc_job, &cd, nullptr, 0);
    dali_tpu_pool_wait_all(pool);
  }
}

namespace {
struct NibJob {
  signed char* vals;
  long long n;
  unsigned char* nibs;
  long long* esc_out;
};
void run_nib_job(void* p) {
  NibJob* j = static_cast<NibJob*>(p);
  *j->esc_out = dali_tpu_nib_pack_i8(j->vals, j->n, j->nibs, j->vals);
}
}  // namespace

// Wire pack for PRE-COMPACTED value streams (the pack-emit decoder already
// produced masks + contiguous values): nibble-packs both AC streams
// (escapes in-place into the vals front) and escape-packs both DC planes.
// counts[4]: y_val_esc, c_val_esc, y_dc_esc, c_dc_esc.
void dali_tpu_pack_wire2(void* pool, signed char* y_vals, long long y_nnz,
                         signed char* c_vals, long long c_nnz,
                         const short* y_dc, const short* c_dc,
                         long long ny_blocks, long long nc_blocks,
                         long long y_dc_len, long long c_dc_len,
                         unsigned char* y_nibs, unsigned char* c_nibs,
                         signed char* y_dc8, short* y_esc16,
                         signed char* c_dc8, short* c_esc16,
                         long long* counts) {
  NibJob yn = {y_vals, y_nnz, y_nibs, &counts[0]};
  NibJob cn = {c_vals, c_nnz, c_nibs, &counts[1]};
  DcJob yd = {y_dc, ny_blocks, y_dc_len, y_dc8, y_esc16, &counts[2]};
  DcJob cd = {c_dc, nc_blocks, c_dc_len, c_dc8, c_esc16, &counts[3]};
  if (pool == nullptr || dali_tpu_pool_num_threads(pool) <= 1) {
    run_nib_job(&yn);
    run_nib_job(&cn);
    run_dc_job(&yd);
    run_dc_job(&cd);
  } else {
    dali_tpu_task_submit(pool, run_nib_job, &yn, nullptr, 0);
    dali_tpu_task_submit(pool, run_nib_job, &cn, nullptr, 0);
    dali_tpu_task_submit(pool, run_dc_job, &yd, nullptr, 0);
    dali_tpu_task_submit(pool, run_dc_job, &cd, nullptr, 0);
    dali_tpu_pool_wait_all(pool);
  }
}

// Escape-pack an int16 stream (hybrid DC planes) to int8: values in
// [-127, 127] pass through; anything else becomes the marker -128 with the
// full int16 appended to `escapes` (typically ~1% of quantized DC terms).
// Returns the escape count. `escapes` must hold n values (worst case).
long long dali_tpu_esc_pack_i16(const short* vals, long long n,
                                signed char* out8, short* escapes) {
  long long e = 0;
  long long i = 0;
#if defined(__SSSE3__)
  const __m128i lo = _mm_set1_epi16(127);
  const __m128i hi = _mm_set1_epi16(-127);
  const __m128i mark = _mm_set1_epi8(-128);
  for (; i + 16 <= n; i += 16) {
    __m128i a = _mm_loadu_si128(reinterpret_cast<const __m128i*>(vals + i));
    __m128i b = _mm_loadu_si128(reinterpret_cast<const __m128i*>(vals + i + 8));
    __m128i ea = _mm_or_si128(_mm_cmpgt_epi16(a, lo), _mm_cmpgt_epi16(hi, a));
    __m128i eb = _mm_or_si128(_mm_cmpgt_epi16(b, lo), _mm_cmpgt_epi16(hi, b));
    __m128i esc8 = _mm_packs_epi16(ea, eb);  // lane masks survive packs
    __m128i sat = _mm_packs_epi16(a, b);
    __m128i out = _mm_or_si128(_mm_andnot_si128(esc8, sat),
                               _mm_and_si128(esc8, mark));
    _mm_storeu_si128(reinterpret_cast<__m128i*>(out8 + i), out);
    unsigned em = (unsigned)_mm_movemask_epi8(esc8);
    while (em) {
      int bpos = __builtin_ctz(em);
      escapes[e++] = vals[i + bpos];
      em &= em - 1;
    }
  }
#endif
  for (; i < n; i++) {
    int v = vals[i];
    if (v < -127 || v > 127) {
      out8[i] = -128;
      escapes[e++] = (short)v;
    } else {
      out8[i] = (signed char)v;
    }
  }
  return e;
}

}  // extern "C"
