// Host JPEG pixel decode without libjpeg: the counterpart of
// dali_tpu/native/src/jpeg_decode.cc, which decodes through libjpeg-turbo
// with JDCT_ISLOW, and of the cv2 route the reference takes for the JPEGs
// libjpeg will not give as RGB (CMYK and YCCK). This file follows
// libjpeg-turbo 2.1's decompression of the coefficients that jpeg_read_full
// (jpeg_huff.cc) reads, stage by stage, so that the uint8 output is libjpeg's:
//
//  * block smoothing of progressive streams whose coefficients are not all
//    known (jdcoefct.c smoothing_ok / decompress_smooth_data): estimates of
//    the first nine AC coefficients, and of DC where no AC is known, from the
//    5x5 neighbourhood of DC values;
//  * scaled decode (denom 1, 2, 4, 8): output ceil(w/denom) x ceil(h/denom);
//    each component's IDCT size starts at 8/denom and doubles while that
//    replaces upsampling (jdmaster.c jpeg_calc_output_dimensions);
//  * IDCTs: the 8x8 integer islow (jidctint.c) and the reduced 4x4, 2x2, 1x1
//    (jidctred.c), 13 constant bits, 2 pass-1 bits, in the 16-bit lanes of
//    the x86-64 build's SIMD versions (the 1x1 is C), whose wraps and
//    saturations damaged streams reach (idct_8x8 and below);
//  * upsampling (jdsample.c), for any integral ratio of sampling factors:
//    fancy h2v1, h1v2 and h2v2 (triangular, with alternating rounding biases
//    and edge rows repeated), else box replication (int_upsample); fancy only
//    above 1/8 scale, and h2v1/h2v2 fancy only for components wider than 2
//    samples. libjpeg's merged upsampler (no fancy upsampling) equals box
//    replication followed by colour conversion;
//  * colour (jdcolor.c): YCbCr -> RGB through the fixed-point tables (16
//    bits), RGB passed through, RGB -> grey, YCbCr -> grey as the Y plane,
//    grey -> RGB replicated, YCCK -> CMYK;
//  * the cv2 route (OpenCV's JPEG reader, grfmt_jpeg.cpp): libjpeg's CMYK
//    samples with fancy upsampling, then OpenCV's CMYK -> BGR or CMYK -> grey
//    (imgcodecs utils.cpp icvCvt_CMYK2BGR_8u_C4C3R / icvCvt_CMYK2Gray_8u_C4C1R).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

#include "jpeg_full.h"

namespace {

using dali_tpu_torch::JpegFull;

constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;

inline int64_t descale(int64_t x, int n) { return (x + ((int64_t)1 << (n - 1))) >> n; }

// The 1x1 IDCT's range limit: libjpeg-turbo's C jpeg_idct_1x1 wraps the
// value to 10 bits (x & RANGE_MASK), then clamps.
inline uint8_t idct_limit_wrap(int64_t x) {
  int v = (int)(x & 1023);
  v = v < 512 ? v + 128 : v - 1024 + 128;
  return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
}

// The 8x8, 4x4 and 2x2 IDCTs of the x86-64 build are SIMD (jidctint-avx2,
// jidctred-sse2): the arithmetic of jidctint.c / jidctred.c in 16-bit lanes
// with 32-bit products. Within range they equal the C; outside it (damaged
// streams, 16-bit quantisers) the lanes wrap or saturate, and the port
// follows them: the dequantisation keeps the product's low 16 bits
// (pmullw); a block whose AC rows are all zero takes the DC shortcut,
// shifted in 16 bits (psllw); the 16-bit sums of the 8x8's even and odd
// parts wrap (paddw); sums of products wrap in 32 bits (pmaddwd, paddd);
// each pass ends in a saturation to 16 bits (packssdw), the second then to
// 8 bits (packsswb) before +128.
inline int16_t w16(int64_t v) { return (int16_t)(uint16_t)(uint64_t)v; }
inline int32_t w32(int64_t v) { return (int32_t)(uint32_t)(uint64_t)v; }
inline int16_t sat16(int32_t v) { return (int16_t)(v < -32768 ? -32768 : v > 32767 ? 32767 : v); }
inline int32_t descale32(int32_t x, int n) { return w32((int64_t)x + (1 << (n - 1))) >> n; }
inline uint8_t idct_out(int32_t x, int n) {
  const int v = sat16(descale32(x, n));
  return (uint8_t)((v < -128 ? -128 : v > 127 ? 127 : v) + 128);
}
inline int32_t madd(int16_t a, int ca, int16_t b, int cb) {
  return w32((int64_t)a * ca + (int64_t)b * cb);
}

// Dequantised block, and whether the AC rows the IDCT reads are all zero.
inline bool dequant(const short* in, const uint16_t* q, int16_t* dq, uint64_t rows) {
  bool zero = true;
  for (int k = 0; k < 64; k++) {
    dq[k] = w16((int64_t)in[k] * (int16_t)q[k]);
    if (k >= 8 && (rows >> (k / 8) & 1) && in[k]) zero = false;
  }
  return zero;
}

// jidctint.c's 1-D islow as jidctint-avx2's dodct: eight 16-bit inputs,
// eight 32-bit sums before the descale.
void islow_1d(const int16_t* in, int step, int32_t* o) {
  const int16_t i0 = in[0], i1 = in[step], i2 = in[2 * step], i3 = in[3 * step],
                i4 = in[4 * step], i5 = in[5 * step], i6 = in[6 * step], i7 = in[7 * step];
  const int32_t tmp3e = madd(i2, 4433 + 6270, i6, 4433), tmp2e = madd(i2, 4433, i6, 4433 - 15137);
  const int32_t tmp0e = (int32_t)w16(i0 + i4) * (1 << 13), tmp1e = (int32_t)w16(i0 - i4) * (1 << 13);
  const int32_t t10 = w32((int64_t)tmp0e + tmp3e), t13 = w32((int64_t)tmp0e - tmp3e);
  const int32_t t11 = w32((int64_t)tmp1e + tmp2e), t12 = w32((int64_t)tmp1e - tmp2e);
  const int16_t z3 = w16(i7 + i3), z4 = w16(i5 + i1);
  const int32_t z3o = madd(z3, 9633 - 16069, z4, 9633), z4o = madd(z3, 9633, z4, 9633 - 3196);
  const int32_t tmp0 = w32((int64_t)madd(i7, 2446 - 7373, i1, -7373) + z3o);
  const int32_t tmp1 = w32((int64_t)madd(i5, 16819 - 20995, i3, -20995) + z4o);
  const int32_t tmp2 = w32((int64_t)madd(i5, -20995, i3, 25172 - 20995) + z3o);
  const int32_t tmp3 = w32((int64_t)madd(i7, -7373, i1, 12299 - 7373) + z4o);
  o[0] = w32((int64_t)t10 + tmp3);
  o[7] = w32((int64_t)t10 - tmp3);
  o[1] = w32((int64_t)t11 + tmp2);
  o[6] = w32((int64_t)t11 - tmp2);
  o[2] = w32((int64_t)t12 + tmp1);
  o[5] = w32((int64_t)t12 - tmp1);
  o[3] = w32((int64_t)t13 + tmp0);
  o[4] = w32((int64_t)t13 - tmp0);
}

// jidctint.c jpeg_idct_islow (jsimd_idct_islow_avx2)
void idct_8x8(const short* in, const uint16_t* q, uint8_t* out, long stride) {
  int16_t dq[64], ws[64];
  int32_t o[8];
  if (dequant(in, q, dq, 0xFE)) {
    for (int c = 0; c < 8; c++)
      for (int r = 0; r < 8; r++) ws[r * 8 + c] = w16((int32_t)dq[c] * 4);
  } else {
    for (int c = 0; c < 8; c++) {
      islow_1d(dq + c, 8, o);
      for (int r = 0; r < 8; r++) ws[r * 8 + c] = sat16(descale32(o[r], 11));
    }
  }
  for (int r = 0; r < 8; r++) {
    islow_1d(ws + r * 8, 1, o);
    for (int c = 0; c < 8; c++) out[r * stride + c] = idct_out(o[c], 18);
  }
}

// jidctred.c's 1-D 4-point IDCT (columns 0-3, 5-7 of an 8-point input) as
// jidctred-sse2 computes it: four 32-bit sums before the descale.
void red4_1d(const int16_t* in, int step, int32_t* o) {
  const int16_t i0 = in[0], i1 = in[step], i2 = in[2 * step], i3 = in[3 * step],
                i5 = in[5 * step], i6 = in[6 * step], i7 = in[7 * step];
  const int32_t t0 = (int32_t)i0 * (1 << 14);
  const int32_t t2 = madd(i2, 15137, i6, -6270);
  const int32_t t10 = w32((int64_t)t0 + t2), t12 = w32((int64_t)t0 - t2);
  const int32_t a = w32((int64_t)madd(i7, -1730, i5, 11893) + madd(i3, -17799, i1, 8697));
  const int32_t b = w32((int64_t)madd(i7, -4176, i5, -4926) + madd(i3, 7373, i1, 20995));
  o[0] = w32((int64_t)t10 + b);
  o[3] = w32((int64_t)t10 - b);
  o[1] = w32((int64_t)t12 + a);
  o[2] = w32((int64_t)t12 - a);
}

// jidctred.c jpeg_idct_4x4 (jsimd_idct_4x4_sse2)
void idct_4x4(const short* in, const uint16_t* q, uint8_t* out, long stride) {
  int16_t dq[64], ws[32];
  int32_t o[4];
  if (dequant(in, q, dq, 0xEE)) {
    for (int c = 0; c < 8; c++)
      for (int r = 0; r < 4; r++) ws[r * 8 + c] = w16((int32_t)dq[c] * 4);
  } else {
    for (int c = 0; c < 8; c++) {
      red4_1d(dq + c, 8, o);
      for (int r = 0; r < 4; r++) ws[r * 8 + c] = sat16(descale32(o[r], 12));
    }
  }
  for (int r = 0; r < 4; r++) {
    red4_1d(ws + r * 8, 1, o);
    for (int c = 0; c < 4; c++) out[r * stride + c] = idct_out(o[c], 19);
  }
}

// jidctred.c's odd part of the 2-point IDCT (inputs 1, 3, 5, 7)
inline int32_t red2_odd(int16_t i1, int16_t i3, int16_t i5, int16_t i7) {
  return w32((int64_t)madd(i1, 29692, i3, -10426) + madd(i5, 6967, i7, -5906));
}

// jidctred.c jpeg_idct_2x2 (jsimd_idct_2x2_sse2): no DC shortcut; pass 1's
// column 0 stays in 32 bits (pass 2 shifts it there), columns 1, 3, 5, 7
// saturate to 16 bits for pass 2's products.
void idct_2x2(const short* in, const uint16_t* q, uint8_t* out, long stride) {
  int16_t dq[64];
  dequant(in, q, dq, 0);
  int32_t col0[2];
  int16_t odd[2][4];
  const int cols[5] = {0, 1, 3, 5, 7};
  for (int k = 0; k < 5; k++) {
    const int c = cols[k];
    const int32_t t10 = (int32_t)dq[c] * (1 << 15);
    const int32_t t0 = red2_odd(dq[8 + c], dq[24 + c], dq[40 + c], dq[56 + c]);
    for (int r = 0; r < 2; r++) {
      const int32_t v = descale32(w32(r ? (int64_t)t10 - t0 : (int64_t)t10 + t0), 13);
      if (k == 0) col0[r] = v;
      else odd[r][k - 1] = sat16(v);
    }
  }
  for (int r = 0; r < 2; r++) {
    const int32_t t10 = w32((int64_t)col0[r] << 15);
    const int32_t t0 = red2_odd(odd[r][0], odd[r][1], odd[r][2], odd[r][3]);
    out[r * stride] = idct_out(w32((int64_t)t10 + t0), 20);
    out[r * stride + 1] = idct_out(w32((int64_t)t10 - t0), 20);
  }
}

// jidctred.c jpeg_idct_1x1
void idct_1x1(const short* in, const uint16_t* q, uint8_t* out, long) {
  out[0] = idct_limit_wrap(descale((int64_t)in[0] * q[0], 3));
}

// One component's IDCT output: bh*s x bw*s samples, s = its IDCT size.
struct Plane {
  std::vector<uint8_t> px;
  long stride = 0;
  int s = 8;       // IDCT size (DCT_scaled_size)
  int dw = 0, dh = 0;  // valid samples (downsampled_width / _height)
  const uint8_t* row(int r) const { return px.data() + (long)r * stride; }
};

void idct_plane(const JpegFull& f, int c, const short* coef, int s, Plane* p) {
  p->s = s;
  p->stride = (long)f.bw[c] * s;
  p->px.resize((size_t)p->stride * f.bh[c] * s);
  p->dw = (int)(((long)f.W * f.h[c] * s + 8L * f.hmax - 1) / (8L * f.hmax));
  p->dh = (int)(((long)f.H * f.v[c] * s + 8L * f.vmax - 1) / (8L * f.vmax));
  void (*idct)(const short*, const uint16_t*, uint8_t*, long) =
      s == 8 ? idct_8x8 : s == 4 ? idct_4x4 : s == 2 ? idct_2x2 : idct_1x1;
  const short* blk = coef;
  for (int br = 0; br < f.bh[c]; br++)
    for (int bc = 0; bc < f.bw[c]; bc++, blk += 64)
      idct(blk, f.q[c], p->px.data() + (long)br * s * p->stride + (long)bc * s, p->stride);
}

// jdcolor.c build_ycc_rgb_table
struct YccTables {
  int cr_r[256], cb_b[256];
  int32_t cr_g[256], cb_g[256];  // |values| < 2^23: their sum fits 32 bits
  YccTables() {
    const int64_t one_half = (int64_t)1 << 15;
    auto fix = [](double x) { return (int64_t)(x * 65536.0 + 0.5); };
    for (int i = 0; i < 256; i++) {
      const int64_t x = i - 128;
      cr_r[i] = (int)((fix(1.40200) * x + one_half) >> 16);
      cb_b[i] = (int)((fix(1.77200) * x + one_half) >> 16);
      cr_g[i] = (int32_t)(-fix(0.71414) * x);
      cb_g[i] = (int32_t)(-fix(0.34414) * x + one_half);
    }
  }
};
const YccTables kYcc;

inline uint8_t clamp255(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }

enum Up { kFull, kH2V1Fancy, kH1V2Fancy, kH2V2Fancy, kBox };

// jdsample.c jinit_upsampler: the method of one component
struct Upsampler {
  const Plane* p;
  Up method;
  int hexp = 1, vexp = 1;  // box factors
  std::vector<int> sums;      // h2v2: the vertical sums of one row
  std::vector<uint8_t> full;  // the whole upsampled row (2 * dw samples)

  // Output row r of the upsampled component, ow samples, into out.
  void row(int r, int ow, uint8_t* out) {
    const Plane& P = *p;
    switch (method) {
      case kFull:
        std::memcpy(out, P.row(r), ow);
        return;
      case kBox: {
        const uint8_t* in = P.row(r / vexp);
        for (int c = 0; c < ow; c++) out[c] = in[c / hexp];
        return;
      }
      case kH2V1Fancy: {
        const uint8_t* in = P.row(r);
        const int dw = P.dw;
        full.resize(2 * dw);
        uint8_t* o = full.data();
        o[0] = in[0];
        o[1] = (uint8_t)((in[0] * 3 + in[1] + 2) >> 2);
        for (int i = 1; i < dw - 1; i++) {
          const int v = in[i] * 3;
          o[2 * i] = (uint8_t)((v + in[i - 1] + 1) >> 2);
          o[2 * i + 1] = (uint8_t)((v + in[i + 1] + 2) >> 2);
        }
        o[2 * dw - 2] = (uint8_t)((in[dw - 1] * 3 + in[dw - 2] + 1) >> 2);
        o[2 * dw - 1] = in[dw - 1];
        std::memcpy(out, o, ow);
        return;
      }
      case kH1V2Fancy:
      case kH2V2Fancy: {
        const int ir = r / 2;
        const int nr = std::min(std::max(r % 2 == 0 ? ir - 1 : ir + 1, 0), P.dh - 1);
        const uint8_t* in0 = P.row(ir);
        const uint8_t* in1 = P.row(nr);
        const int dw = P.dw;
        if (method == kH1V2Fancy) {
          const int bias = r % 2 == 0 ? 1 : 2;
          for (int c = 0; c < ow; c++) out[c] = (uint8_t)((in0[c] * 3 + in1[c] + bias) >> 2);
          return;
        }
        sums.resize(dw);
        for (int i = 0; i < dw; i++) sums[i] = in0[i] * 3 + in1[i];
        full.resize(2 * dw);
        uint8_t* o = full.data();
        o[0] = (uint8_t)((sums[0] * 4 + 8) >> 4);
        o[1] = (uint8_t)((sums[0] * 3 + sums[1] + 7) >> 4);
        for (int i = 1; i < dw - 1; i++) {
          o[2 * i] = (uint8_t)((sums[i] * 3 + sums[i - 1] + 8) >> 4);
          o[2 * i + 1] = (uint8_t)((sums[i] * 3 + sums[i + 1] + 7) >> 4);
        }
        o[2 * dw - 2] = (uint8_t)((sums[dw - 1] * 3 + sums[dw - 2] + 8) >> 4);
        o[2 * dw - 1] = (uint8_t)((sums[dw - 1] * 4 + 7) >> 4);
        std::memcpy(out, o, ow);
        return;
      }
    }
  }
};

// Returns false where libjpeg fails: a ratio of sampling factors that is
// not integral (JERR_FRACT_SAMPLE_NOTIMPL).
bool pick_method(const JpegFull& f, int c, int min_s, bool fancy, Upsampler* u) {
  const Plane& P = *u->p;
  const int h_in = f.h[c] * P.s / min_s, v_in = f.v[c] * P.s / min_s;
  const int h_out = f.hmax, v_out = f.vmax;
  const bool do_fancy = fancy && min_s > 1;
  if (h_in == h_out && v_in == v_out) {
    u->method = kFull;
  } else if (h_in * 2 == h_out && v_in == v_out) {
    u->method = do_fancy && P.dw > 2 ? kH2V1Fancy : kBox;
  } else if (h_in == h_out && v_in * 2 == v_out && do_fancy) {
    u->method = kH1V2Fancy;
  } else if (h_in * 2 == h_out && v_in * 2 == v_out && do_fancy && P.dw > 2) {
    u->method = kH2V2Fancy;
  } else if (h_out % h_in == 0 && v_out % v_in == 0) {
    u->method = kBox;
  } else {
    return false;
  }
  u->hexp = h_out / h_in;
  u->vexp = v_out / v_in;
  return true;
}

// ---------------------------------------------------------------------------
// Block smoothing (libjpeg-turbo 2.1 jdcoefct.c).

// Natural positions of the coefficients smoothing estimates, in zigzag
// order 1-9 (coef_bits index): AC01 AC10 AC20 AC11 AC02 AC03 AC12 AC21 AC30.
constexpr int kSmoothPos[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};

// smoothing_ok: every component's DC partly known and its first ten
// quantisers nonzero, and some coefficient 1-9 of some component not known
// to full precision.
bool smoothing_ok(const JpegFull& f) {
  if (!f.progressive) return false;
  bool useful = false;
  for (int c = 0; c < f.ncomp; c++) {
    for (int k = 0; k < 10; k++)
      if (f.q[c][kSmoothPos[k]] == 0) return false;
    if (f.coef_bits[c][0] < 0) return false;
    for (int k = 1; k < 10; k++)
      if (f.coef_bits[c][k] != 0) useful = true;
  }
  return useful;
}

// One estimate: the coefficient's prediction from num, limited to what its
// unknown low bits can hold.
inline short smooth_pred(int64_t num, int64_t q, int al) {
  int pred = (int)(((q << 7) + (num >= 0 ? num : -num)) / (q << 8));
  if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
  return (short)(num >= 0 ? pred : -pred);
}

// decompress_smooth_data over component c: out gets its blocks, each with
// the estimates applied to coefficients still zero and not known exactly.
void smooth_plane(const JpegFull& f, int c, std::vector<short>* out) {
  const int bh = f.bh[c], bw = f.bw[c], V = f.v[c];
  const short* in = f.coef[c].data();
  out->assign(in, in + (size_t)bh * bw * 64);
  const int last = (f.H + 8 * f.vmax - 1) / (8 * f.vmax) - 1;  // last iMCU row
  // libjpeg's latches: the scan in progress when the data ran out counts
  // only for the iMCU rows it reached; later rows see the status before it
  int cur[10], prev[10];
  for (int k = 0; k < 10; k++) {
    cur[k] = f.coef_bits[c][k];
    prev[k] = f.nscans > 1 ? f.prev_bits[c][k] : -1;
  }
  const int64_t Q00 = f.q[c][0], Q01 = f.q[c][1], Q10 = f.q[c][8], Q20 = f.q[c][16],
                Q11 = f.q[c][9], Q02 = f.q[c][2], Q03 = f.q[c][3], Q12 = f.q[c][10],
                Q21 = f.q[c][17], Q30 = f.q[c][24];
  auto dc = [&](int r, int b) -> int64_t { return in[((size_t)r * bw + b) * 64]; };
  for (int r = 0; r < bh; r++) {
    const int imcu = r / V, brow = r % V;
    const int block_rows = imcu < last ? V : (bh % V ? bh % V : V);
    // neighbouring block rows as libjpeg's buffer pointers give them
    const int rp = (brow > 0 || imcu > 0) ? r - 1 : r;
    const int rpp = (brow > 1 || imcu > 1) ? r - 2 : rp;
    const int rn = (brow < block_rows - 1 || imcu < last) ? r + 1 : r;
    const int rnn = (brow < block_rows - 2 || imcu + 1 < last) ? r + 2 : rn;
    const int* bits = imcu > f.last_good_row ? prev : cur;
    bool change_dc = true;
    for (int k = 1; k < 10; k++)
      if (bits[k] != -1) change_dc = false;
    const int rows[5] = {rpp, rp, r, rn, rnn};
    // libjpeg's sliding registers D[1..25] = DC01..DC25, rows top to bottom:
    // all start at column 0; the first block loads column 1 into the fourth
    // register only, each block loads column b + 2 into the fifth while one
    // exists (a component two blocks wide keeps column 0 there)
    int64_t D[26];
    for (int i = 0; i < 5; i++)
      for (int j = 0; j < 5; j++) D[1 + i * 5 + j] = dc(rows[i], 0);
    for (int b = 0; b < bw; b++) {
      short* ws = out->data() + ((size_t)r * bw + b) * 64;
      for (int i = 0; i < 5; i++) {
        if (b == 0 && bw > 1) D[4 + i * 5] = dc(rows[i], 1);
        if (b + 1 < bw - 1) D[5 + i * 5] = dc(rows[i], b + 2);
      }
      int al;
      if ((al = bits[1]) != 0 && ws[1] == 0) {
        const int64_t num =
            Q00 * (change_dc ? (-D[1] - D[2] + D[4] + D[5] - 3 * D[6] + 13 * D[7] - 13 * D[9] +
                                3 * D[10] - 3 * D[11] + 38 * D[12] - 38 * D[14] + 3 * D[15] -
                                3 * D[16] + 13 * D[17] - 13 * D[19] + 3 * D[20] - D[21] - D[22] +
                                D[24] + D[25])
                             : (-7 * D[11] + 50 * D[12] - 50 * D[14] + 7 * D[15]));
        ws[1] = smooth_pred(num, Q01, al);
      }
      if ((al = bits[2]) != 0 && ws[8] == 0) {
        const int64_t num =
            Q00 * (change_dc ? (-D[1] - 3 * D[2] - 3 * D[3] - 3 * D[4] - D[5] - D[6] +
                                13 * D[7] + 38 * D[8] + 13 * D[9] - D[10] + D[16] - 13 * D[17] -
                                38 * D[18] - 13 * D[19] + D[20] + D[21] + 3 * D[22] + 3 * D[23] +
                                3 * D[24] + D[25])
                             : (-7 * D[3] + 50 * D[8] - 50 * D[18] + 7 * D[23]));
        ws[8] = smooth_pred(num, Q10, al);
      }
      if ((al = bits[3]) != 0 && ws[16] == 0) {
        const int64_t num =
            Q00 * (change_dc ? (D[3] + 2 * D[7] + 7 * D[8] + 2 * D[9] - 5 * D[12] - 14 * D[13] -
                                5 * D[14] + 2 * D[17] + 7 * D[18] + 2 * D[19] + D[23])
                             : (-D[3] + 13 * D[8] - 24 * D[13] + 13 * D[18] - D[23]));
        ws[16] = smooth_pred(num, Q20, al);
      }
      if ((al = bits[4]) != 0 && ws[9] == 0) {
        const int64_t num =
            Q00 * (change_dc ? (-D[1] + D[5] + 9 * D[7] - 9 * D[9] - 9 * D[17] + 9 * D[19] +
                                D[21] - D[25])
                             : (D[10] + D[16] - 10 * D[17] + 10 * D[19] - D[2] - D[20] + D[22] -
                                D[24] + D[4] - D[6] + 10 * D[7] - 10 * D[9]));
        ws[9] = smooth_pred(num, Q11, al);
      }
      if ((al = bits[5]) != 0 && ws[2] == 0) {
        const int64_t num =
            Q00 * (change_dc ? (2 * D[7] - 5 * D[8] + 2 * D[9] + D[11] + 7 * D[12] - 14 * D[13] +
                                7 * D[14] + D[15] + 2 * D[17] - 5 * D[18] + 2 * D[19])
                             : (-D[11] + 13 * D[12] - 24 * D[13] + 13 * D[14] - D[15]));
        ws[2] = smooth_pred(num, Q02, al);
      }
      if (change_dc) {
        if ((al = bits[6]) != 0 && ws[3] == 0)
          ws[3] = smooth_pred(Q00 * (D[7] - D[9] + 2 * D[12] - 2 * D[14] + D[17] - D[19]), Q03, al);
        if ((al = bits[7]) != 0 && ws[10] == 0)
          ws[10] = smooth_pred(Q00 * (D[7] - 3 * D[8] + D[9] - D[17] + 3 * D[18] - D[19]), Q12, al);
        if ((al = bits[8]) != 0 && ws[17] == 0)
          ws[17] = smooth_pred(Q00 * (D[7] - D[9] - 3 * D[12] + 3 * D[14] + D[17] - D[19]), Q21, al);
        if ((al = bits[9]) != 0 && ws[24] == 0)
          ws[24] = smooth_pred(Q00 * (D[7] + 2 * D[8] + D[9] - D[17] - 2 * D[18] - D[19]), Q30, al);
        const int64_t num =
            Q00 * (-2 * D[1] - 6 * D[2] - 8 * D[3] - 6 * D[4] - 2 * D[5] - 6 * D[6] + 6 * D[7] +
                   42 * D[8] + 6 * D[9] - 6 * D[10] - 8 * D[11] + 42 * D[12] + 152 * D[13] +
                   42 * D[14] - 8 * D[15] - 6 * D[16] + 6 * D[17] + 42 * D[18] + 6 * D[19] -
                   6 * D[20] - 2 * D[21] - 6 * D[22] - 8 * D[23] - 6 * D[24] - 2 * D[25]);
        ws[0] = smooth_pred(num, Q00, 0);
      }
      for (int i = 0; i < 5; i++)
        for (int j = 1; j < 5; j++) D[i * 5 + j] = D[i * 5 + j + 1];
    }
  }
}

// ---------------------------------------------------------------------------
// Colour conversion of one output row.

// jdcolor.c build_rgb_y_table: R_Y, G_Y, B_Y (+ ONE_HALF)
constexpr int64_t kRY = 19595, kGY = 38470, kBY = 7471;
// OpenCV's grey weights (imgcodecs utils.cpp: cR, cG, cB at SCALE 14)
constexpr int kCvR = 4899, kCvG = 9617, kCvB = 1868;

// OpenCV icvCvt_CMYK2BGR's per-channel step
inline int cv_cmyk(int x, int k) { return k - ((255 - x) * k >> 8); }

}  // namespace

extern "C" {

// Output size at 1/denom scale (libjpeg rounds up). Returns as jpeg_read_header.
int dali_tpu_torch_jpeg_scaled_dims(const char* data, size_t len, int denom, int* h, int* w,
                                    int* c) {
  JpegFull f;
  int rc = dali_tpu_torch::jpeg_read_header(reinterpret_cast<const uint8_t*>(data), len, &f);
  if (rc != 0) return rc;
  if (denom != 1 && denom != 2 && denom != 4 && denom != 8) return -3;
  *h = (f.H + denom - 1) / denom;
  *w = (f.W + denom - 1) / denom;
  *c = f.ncomp;
  return 0;
}

// Decode into a strided destination: RGB (3 bytes a pixel) or, with gray,
// one byte a pixel. Rows are dst_stride bytes apart; the image is written at
// the top left. Returns 0 for a stream decoded as libjpeg gives it; 2 for a
// CMYK or YCCK stream, which libjpeg will not give as RGB or grey and the
// reference decodes through cv2 (its output is cv2's: fancy upsampling
// always, OpenCV's CMYK conversion); 1 unsupported stream; -1 corrupt (or a
// stream libjpeg fails on, or a CMYK/YCCK stream that ends before its EOI
// marker); -2 the output size is not expect_h x expect_w;
// -3 bad denom.
int dali_tpu_torch_decode_jpeg_into(const char* data, size_t len, int denom, unsigned char* dst,
                                    long dst_stride, int expect_h, int expect_w, int fancy,
                                    int gray) {
  if (denom != 1 && denom != 2 && denom != 4 && denom != 8) return -3;
  // per-thread scratch, reused across the images a pool worker decodes
  thread_local JpegFull f;
  int rc = dali_tpu_torch::jpeg_read_full(reinterpret_cast<const uint8_t*>(data), len, &f);
  if (rc != 0) return rc;
  const int oh = (f.H + denom - 1) / denom, ow = (f.W + denom - 1) / denom;
  if (oh != expect_h || ow != expect_w) return -2;
  return dali_tpu_torch::jpeg_decode_pixels(f, denom, dst, dst_stride, fancy, gray);
}

}  // extern "C"

namespace dali_tpu_torch {

int jpeg_decode_pixels(const JpegFull& f, int denom, unsigned char* dst, long dst_stride,
                       int fancy, int gray) {
  thread_local Plane planes[4];
  thread_local std::vector<short> smoothed[4];
  thread_local std::vector<uint8_t> rows;
  const int oh = (f.H + denom - 1) / denom, ow = (f.W + denom - 1) / denom;
  const bool cv2_route = f.color == kCMYK || f.color == kYCCK;
  if (!cv2_route && f.color != kGray && f.color != kYCbCr && f.color != kRGB) return -1;
  // OpenCV's data source suspends at the end of the data, and cv2 fails
  if (cv2_route && !f.eoi) return -1;
  // the reference's grey decode and cv2 leave libjpeg's fancy upsampling on
  if (gray || cv2_route) fancy = 1;
  const int min_s = 8 / denom;
  const int nused = (f.color == kGray || (gray && f.color == kYCbCr)) ? 1 : f.ncomp;
  const bool smooth = smoothing_ok(f);
  Upsampler ups[4];
  for (int c = 0; c < nused; c++) {
    // a component is scaled up by a larger IDCT where that replaces upsampling
    int s = min_s;
    while (s < 8 && (f.hmax * min_s) % (f.h[c] * s * 2) == 0 &&
           (f.vmax * min_s) % (f.v[c] * s * 2) == 0)
      s *= 2;
    const short* coef = f.coef[c].data();
    if (smooth) {
      smooth_plane(f, c, &smoothed[c]);
      coef = smoothed[c].data();
    }
    idct_plane(f, c, coef, s, &planes[c]);
    ups[c].p = &planes[c];
    if (!pick_method(f, c, min_s, fancy != 0, &ups[c])) return -1;
  }
  rows.resize(4 * (size_t)ow);
  uint8_t* in[4] = {rows.data(), rows.data() + ow, rows.data() + 2 * ow, rows.data() + 3 * ow};
  for (int r = 0; r < oh; r++) {
    for (int c = 0; c < nused; c++) ups[c].row(r, ow, in[c]);
    unsigned char* o = dst + (long)r * dst_stride;
    const uint8_t *c0 = in[0], *c1 = in[1], *c2 = in[2], *c3 = in[3];
    if (nused == 1) {
      if (gray) {
        std::memcpy(o, c0, ow);
      } else {
        for (int x = 0; x < ow; x++) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = c0[x];
      }
    } else if (f.color == kYCbCr) {
      for (int x = 0; x < ow; x++) {
        const int y = c0[x], cb = c1[x], cr = c2[x];
        o[3 * x] = clamp255(y + kYcc.cr_r[cr]);
        o[3 * x + 1] = clamp255(y + (int)((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16));
        o[3 * x + 2] = clamp255(y + kYcc.cb_b[cb]);
      }
    } else if (f.color == kRGB) {
      if (gray) {
        for (int x = 0; x < ow; x++)
          o[x] = (uint8_t)((kRY * c0[x] + kGY * c1[x] + kBY * c2[x] + 32768) >> 16);
      } else {
        for (int x = 0; x < ow; x++) {
          o[3 * x] = c0[x];
          o[3 * x + 1] = c1[x];
          o[3 * x + 2] = c2[x];
        }
      }
    } else {  // CMYK or YCCK: libjpeg's CMYK samples, then OpenCV's conversion
      for (int x = 0; x < ow; x++) {
        int cc = c0[x], m = c1[x], yy = c2[x];
        const int k = c3[x];
        if (f.color == kYCCK) {  // jdcolor.c ycck_cmyk_convert
          const int y = c0[x], cb = c1[x], cr = c2[x];
          cc = clamp255(255 - (y + kYcc.cr_r[cr]));
          m = clamp255(255 - (y + (int)((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16)));
          yy = clamp255(255 - (y + kYcc.cb_b[cb]));
        }
        const int R = cv_cmyk(cc, k), G = cv_cmyk(m, k), B = cv_cmyk(yy, k);
        if (gray) {
          o[x] = (uint8_t)((B * kCvB + G * kCvG + R * kCvR + (1 << 13)) >> 14);
        } else {
          o[3 * x] = (uint8_t)R;
          o[3 * x + 1] = (uint8_t)G;
          o[3 * x + 2] = (uint8_t)B;
        }
      }
    }
  }
  return cv2_route ? 2 : 0;
}

}  // namespace dali_tpu_torch

// ---------------------------------------------------------------------------
// Batch decode on the tasking pool: one call per batch, each sample decoded
// into its slot of a strided canvas (dali_tpu_decode_jpeg_batch).

extern "C" int64_t dali_tpu_task_submit(void*, void (*)(void*), void*, const int64_t*, int);
extern "C" void dali_tpu_pool_wait_all(void*);
extern "C" int dali_tpu_pool_num_threads(void*);

namespace {
struct DecodeJob {
  const char* data;
  size_t len;
  int denom;
  unsigned char* dst;
  long stride;
  int h, w, fancy, gray;
  int* rc;
};

void run_decode_job(void* p) {
  DecodeJob* j = static_cast<DecodeJob*>(p);
  *j->rc = dali_tpu_torch_decode_jpeg_into(j->data, j->len, j->denom, j->dst, j->stride, j->h,
                                           j->w, j->fancy, j->gray);
}
}  // namespace

// rcs[i] gets sample i's return code (0 = decoded). A null pool, or one of
// one thread, decodes inline.
extern "C" int dali_tpu_torch_decode_jpeg_batch(void* pool, const char** datas,
                                                const size_t* lens, const int* denoms,
                                                unsigned char** dsts, const long* strides,
                                                const int* hs, const int* ws, int fancy, int gray,
                                                int n, int* rcs) {
  std::vector<DecodeJob> jobs(n);
  const bool inline_run = pool == nullptr || dali_tpu_pool_num_threads(pool) <= 1;
  for (int i = 0; i < n; i++) {
    jobs[i] = {datas[i], lens[i], denoms[i], dsts[i], strides[i], hs[i], ws[i], fancy, gray,
               &rcs[i]};
    if (inline_run) run_decode_job(&jobs[i]);
    else dali_tpu_task_submit(pool, run_decode_job, &jobs[i], nullptr, 0);
  }
  if (!inline_run) dali_tpu_pool_wait_all(pool);
  return 0;
}
