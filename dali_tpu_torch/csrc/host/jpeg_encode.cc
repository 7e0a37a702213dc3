// The cpu JpegCompressionDistortion of dali_tpu_torch without libjpeg: a
// baseline JPEG round trip at a quality, equal to dali_tpu's
// cv2.imencode(".jpg", quality) followed by cv2.imdecode (OpenCV 5.0 with
// libjpeg-turbo 3.1). The front half follows libjpeg-turbo's compressor up
// to the quantised coefficients; the entropy coder is left out, since it is
// lossless. The back half is the port's decoder (jpeg_decode.cc).
//
//  * quality: jpeg_set_quality(quality, force_baseline=TRUE) of the Annex K
//    tables (jcparam.c jpeg_quality_scaling, jpeg_add_quant_table);
//  * colour: RGB -> YCbCr through jccolor.c's 16-bit fixed-point tables
//    (Cb and Cr rounded with the 0.5 - epsilon fudge), grey passed through;
//  * sampling: cv2's default 4:2:0 (luma 2x2), grey 1x1;
//  * edges (jcsample.c expand_right_edge, jcprepct.c expand_bottom_edge):
//    the last column replicated to the downsampler's width, rows to a
//    multiple of the largest vertical sampling factor, then each component's
//    last row to a whole iMCU row;
//  * downsampling (jcsample.c h2v2_downsample): (a + b + c + d + bias) >> 2,
//    the bias 1, 2, 1, 2, ... along each output row;
//  * the forward DCT: jfdctint.c jpeg_fdct_islow (13 constant bits, 2
//    pass-1 bits) of the samples less 128;
//  * quantisation (jcdctmgr.c compute_reciprocal, quantize): by the
//    reciprocal of 8 q with its correction and shift, the sign restored.

#include <cstddef>
#include <cstdint>
#include <vector>

#include "jpeg_full.h"

namespace {

using dali_tpu_torch::JpegFull;

// jcparam.c std_luminance_quant_tbl / std_chrominance_quant_tbl, natural order
constexpr int kLumaBase[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
constexpr int kChromaBase[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// jcparam.c jpeg_quality_scaling + jpeg_add_quant_table(force_baseline)
void quant_table(const int* base, int quality, uint16_t* out) {
  quality = quality <= 0 ? 1 : quality > 100 ? 100 : quality;
  const long scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  for (int i = 0; i < 64; i++) {
    long t = (base[i] * scale + 50L) / 100L;
    t = t <= 0 ? 1 : t > 32767 ? 32767 : t;
    out[i] = (uint16_t)(t > 255 ? 255 : t);
  }
}

// jccolor.c rgb_ycc_start
struct RgbYcc {
  static constexpr int kBits = 16;
  int32_t ry[256], gy[256], by[256], rcb[256], gcb[256], bcb[256], gcr[256], bcr[256];
  RgbYcc() {
    auto fix = [](double x) { return (int32_t)(x * (1L << kBits) + 0.5); };
    const int32_t half = 1 << (kBits - 1), cbcr_offset = 128 << kBits;
    for (int i = 0; i < 256; i++) {
      ry[i] = fix(0.29900) * i;
      gy[i] = fix(0.58700) * i;
      by[i] = fix(0.11400) * i + half;
      rcb[i] = -fix(0.16874) * i;
      gcb[i] = -fix(0.33126) * i;
      bcb[i] = fix(0.50000) * i + cbcr_offset + half - 1;  // also R's Cr term
      gcr[i] = -fix(0.41869) * i;
      bcr[i] = -fix(0.08131) * i;
    }
  }
};
const RgbYcc kRgbYcc;

// jfdctint.c jpeg_fdct_islow, in place on 64 level-shifted samples
constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int32_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373,
                  F1175 = 9633, F1501 = 12299, F1847 = 15137, F1961 = 16069, F2053 = 16819,
                  F2562 = 20995, F3072 = 25172;

inline int32_t descale(int32_t x, int n) { return (x + (1 << (n - 1))) >> n; }

void fdct_islow(int32_t* d) {
  for (int pass = 0; pass < 2; pass++) {
    const int step = pass == 0 ? 1 : 8, next = pass == 0 ? 8 : 1;
    const int odd_bits = pass == 0 ? kConstBits - kPass1Bits : kConstBits + kPass1Bits;
    for (int k = 0; k < 8; k++) {
      int32_t* p = d + k * next;
      const int32_t tmp0 = p[0] + p[7 * step], tmp7 = p[0] - p[7 * step];
      const int32_t tmp1 = p[step] + p[6 * step], tmp6 = p[step] - p[6 * step];
      const int32_t tmp2 = p[2 * step] + p[5 * step], tmp5 = p[2 * step] - p[5 * step];
      const int32_t tmp3 = p[3 * step] + p[4 * step], tmp4 = p[3 * step] - p[4 * step];
      const int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      const int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      if (pass == 0) {
        p[0] = (tmp10 + tmp11) * (1 << kPass1Bits);
        p[4 * step] = (tmp10 - tmp11) * (1 << kPass1Bits);
      } else {
        p[0] = descale(tmp10 + tmp11, kPass1Bits);
        p[4 * step] = descale(tmp10 - tmp11, kPass1Bits);
      }
      int32_t z1 = (tmp12 + tmp13) * F0541;
      p[2 * step] = descale(z1 + tmp13 * F0765, odd_bits);
      p[6 * step] = descale(z1 + tmp12 * -F1847, odd_bits);
      z1 = tmp4 + tmp7;
      int32_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
      const int32_t z5 = (z3 + z4) * F1175;
      const int32_t t4 = tmp4 * F0298, t5 = tmp5 * F2053, t6 = tmp6 * F3072, t7 = tmp7 * F1501;
      z1 *= -F0899;
      z2 *= -F2562;
      z3 = z3 * -F1961 + z5;
      z4 = z4 * -F0390 + z5;
      p[7 * step] = descale(t4 + z1 + z3, odd_bits);
      p[5 * step] = descale(t5 + z2 + z4, odd_bits);
      p[3 * step] = descale(t6 + z2 + z3, odd_bits);
      p[step] = descale(t7 + z1 + z4, odd_bits);
    }
  }
}

// jcdctmgr.c compute_reciprocal (16-bit DCT elements) of divisor 8 q
struct Divisor {
  uint32_t recip, corr;
  int shift;  // total right shift of (|x| + corr) * recip
};

Divisor reciprocal(uint32_t divisor) {
  if (divisor == 1) return {1, 0, 0};
  int b = 0;
  while ((divisor >> (b + 1)) != 0) b++;  // flss(divisor) - 1
  int r = 16 + b;
  uint32_t fq = (uint32_t)(((uint64_t)1 << r) / divisor);
  const uint32_t fr = (uint32_t)(((uint64_t)1 << r) % divisor);
  uint32_t c = divisor / 2;
  if (fr == 0) {
    fq >>= 1;
    r--;
  } else if (fr <= divisor / 2U) {
    c++;
  } else {
    fq++;
  }
  return {fq, c, r};
}

inline short quantize(int32_t x, const Divisor& d) {
  const uint32_t a = (uint32_t)(x < 0 ? -x : x);
  const int32_t q = (int32_t)(((uint64_t)(a + d.corr) * d.recip) >> d.shift);
  return (short)(x < 0 ? -q : q);
}

// A component's padded sample plane, bh * 8 x bw * 8.
struct Samples {
  int bh = 0, bw = 0;
  std::vector<uint8_t> px;
  uint8_t* row(int r) { return px.data() + (size_t)r * bw * 8; }
};

// Copies rows [valid_rows, bh * 8) from the last valid row (expand_bottom_edge)
void pad_bottom(Samples* s, int valid_rows) {
  for (int r = valid_rows; r < s->bh * 8; r++)
    std::copy(s->row(valid_rows - 1), s->row(valid_rows - 1) + s->bw * 8, s->row(r));
}

void forward(Samples& s, const uint16_t* qtab, std::vector<short>* coef) {
  Divisor div[64];
  for (int i = 0; i < 64; i++) div[i] = reciprocal((uint32_t)qtab[i] << 3);
  coef->assign((size_t)s.bh * s.bw * 64, 0);
  int32_t blk[64];
  for (int br = 0; br < s.bh; br++)
    for (int bc = 0; bc < s.bw; bc++) {
      for (int y = 0; y < 8; y++) {
        const uint8_t* p = s.row(br * 8 + y) + bc * 8;
        for (int x = 0; x < 8; x++) blk[y * 8 + x] = (int32_t)p[x] - 128;
      }
      fdct_islow(blk);
      short* out = coef->data() + ((size_t)br * s.bw + bc) * 64;
      for (int i = 0; i < 64; i++) out[i] = quantize(blk[i], div[i]);
    }
}

// The quantised coefficients of img (h x w, c = 1 or 3 channels, RGB) at
// quality, in f: the frame as jpeg_read_full would leave it.
void encode(const uint8_t* img, int h, int w, int c, int quality, JpegFull* f) {
  const bool color = c == 3;
  f->H = h;
  f->W = w;
  f->ncomp = color ? 3 : 1;
  f->color = color ? dali_tpu_torch::kYCbCr : dali_tpu_torch::kGray;
  f->hmax = f->vmax = color ? 2 : 1;
  f->progressive = false;
  f->eoi = true;
  for (int i = 0; i < 4; i++) f->h[i] = f->v[i] = 1;
  if (color) f->h[0] = f->v[0] = 2;
  Samples s[3];
  // luma: width_in_blocks = ceil(w / 8); rows to a whole iMCU row
  const int imcu = 8 * f->vmax;
  s[0].bw = (w + 7) / 8;
  s[0].bh = (h + imcu - 1) / imcu * (imcu / 8);
  s[0].px.resize((size_t)s[0].bh * 8 * s[0].bw * 8);
  if (!color) {
    for (int y = 0; y < h; y++) {
      uint8_t* o = s[0].row(y);
      const uint8_t* in = img + (size_t)y * w;
      for (int x = 0; x < s[0].bw * 8; x++) o[x] = in[x < w ? x : w - 1];
    }
    pad_bottom(&s[0], h);
  } else {
    const int cw = (w + 15) / 16 * 8, ch = (h + 1) / 2;  // chroma plane width, rows
    for (int k = 1; k < 3; k++) {
      s[k].bw = cw / 8;
      s[k].bh = (h + 15) / 16;
      s[k].px.resize((size_t)s[k].bh * 8 * cw);
    }
    const RgbYcc& t = kRgbYcc;
    // full-resolution Cb, Cr of two input rows, right edge replicated to 2 cw
    std::vector<uint8_t> cb(2 * 2 * cw), cr(2 * 2 * cw);
    for (int y2 = 0; y2 < ch; y2++) {
      for (int j = 0; j < 2; j++) {
        const int y = 2 * y2 + j < h ? 2 * y2 + j : h - 1;  // rows to an even count
        const uint8_t* in = img + (size_t)y * w * 3;
        uint8_t* yo = s[0].row(2 * y2 + j);
        uint8_t* cbo = cb.data() + j * 2 * cw;
        uint8_t* cro = cr.data() + j * 2 * cw;
        for (int x = 0; x < w; x++) {
          const int r = in[3 * x], g = in[3 * x + 1], b = in[3 * x + 2];
          yo[x] = (uint8_t)((t.ry[r] + t.gy[g] + t.by[b]) >> RgbYcc::kBits);
          cbo[x] = (uint8_t)((t.rcb[r] + t.gcb[g] + t.bcb[b]) >> RgbYcc::kBits);
          cro[x] = (uint8_t)((t.bcb[r] + t.gcr[g] + t.bcr[b]) >> RgbYcc::kBits);
        }
        for (int x = w; x < s[0].bw * 8; x++) yo[x] = yo[w - 1];
        for (int x = w; x < 2 * cw; x++) {
          cbo[x] = cbo[w - 1];
          cro[x] = cro[w - 1];
        }
      }
      for (int k = 1; k < 3; k++) {
        const uint8_t* r0 = (k == 1 ? cb : cr).data();
        const uint8_t* r1 = r0 + 2 * cw;
        uint8_t* o = s[k].row(y2);
        int bias = 1;
        for (int x = 0; x < cw; x++, bias ^= 3)
          o[x] = (uint8_t)((r0[2 * x] + r0[2 * x + 1] + r1[2 * x] + r1[2 * x + 1] + bias) >> 2);
      }
    }
    pad_bottom(&s[0], 2 * ch);
    pad_bottom(&s[1], ch);
    pad_bottom(&s[2], ch);
  }
  quant_table(kLumaBase, quality, f->q[0]);
  if (color) {
    quant_table(kChromaBase, quality, f->q[1]);
    quant_table(kChromaBase, quality, f->q[2]);
  }
  // libjpeg's block counts: luma ceil(w / 8) x ceil(h / 8), chroma ceil(/16)
  for (int k = 0; k < f->ncomp; k++) {
    forward(s[k], f->q[k], &f->coef[k]);
    f->bw[k] = s[k].bw;
    f->bh[k] = k == 0 ? (h + 7) / 8 : s[k].bh;
  }
}

}  // namespace

extern "C" {

// The quantised coefficients of one image (uint8 [h, w, c], c = 1 grey or 3
// RGB) at quality: into coef[k] (int16 [bh_k][bw_k][64], natural order, the
// luma's ceil(h / 8) x ceil(w / 8) blocks, each chroma's ceil(h / 16) x
// ceil(w / 16)) and q[k] (its table, natural order). Returns -1 for another
// channel count.
int dali_tpu_torch_jpeg_encode_coefs(const unsigned char* img, int h, int w, int c, int quality,
                                     short** coef, unsigned short** q) {
  if ((c != 1 && c != 3) || h < 1 || w < 1) return -1;
  JpegFull f;
  encode(img, h, w, c, quality, &f);
  for (int k = 0; k < f.ncomp; k++) {
    std::copy(f.coef[k].begin(), f.coef[k].begin() + (size_t)f.bh[k] * f.bw[k] * 64, coef[k]);
    std::copy(f.q[k], f.q[k] + 64, q[k]);
  }
  return 0;
}

// The JPEG round trip of one image (uint8 [h, w, c], c = 1 or 3) at quality,
// decoded to RGB into out [h, w, 3] (grey replicated, as cv2.imdecode's
// IMREAD_COLOR gives it). Returns -1 for another channel count.
int dali_tpu_torch_jpeg_roundtrip(const unsigned char* img, int h, int w, int c, int quality,
                                  unsigned char* out) {
  if ((c != 1 && c != 3) || h < 1 || w < 1) return -1;
  thread_local JpegFull f;
  encode(img, h, w, c, quality, &f);
  return dali_tpu_torch::jpeg_decode_pixels(f, 1, out, (long)w * 3, 1, 0) == 0 ? 0 : -1;
}

}  // extern "C"
