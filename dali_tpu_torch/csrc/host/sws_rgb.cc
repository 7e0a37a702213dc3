// The port's rebuild of the reference's non-4:2:0 route: libswscale 6.7's
// sws_scale(w, h, fmt -> w, h, AV_PIX_FMT_RGB24, SWS_BILINEAR) at 1:1 size,
// for the formats the host decoders emit, as it runs on an x86-64 host with
// SSSE3 (this is what the reference's video_decode.cc calls for every frame
// that is not 4:2:0). libswscale picks one of three routes, and each is
// followed here to the bit (found by fitting against the library on random
// planes, every width from 1 to 400, heights 1 to 48):
//
//   * yuv422p / yuvj422p at an even height: the unscaled x86 converter
//     (x86/yuv2rgb's SSSE3 yuv420_rgb24, which reads chroma row y for
//     4:2:2). In 16-bit lanes, with pmulhw's floor of the high half:
//       Ys = ((8 Y - yOffset) * yCoeff) >> 16
//       u  = 8 U - 1024, v = 8 V - 1024
//       R = Ys + (v*vrCoeff >> 16), B = Ys + (u*ubCoeff >> 16),
//       G = Ys + sat16((u*ugCoeff >> 16) + (v*vgCoeff >> 16)),
//     each saturated to 16 bits, then to 0..255. The converter works in
//     blocks of 16 pixels over h_size = ((w + 7) & ~7) columns, less 8 when
//     h_size * 3 exceeds the row: the columns from min(w, max(16,
//     16 * ceil(h_size / 16))) on are never written (the reference returns
//     whatever its output buffer held there), and a row whose last block
//     passes its end writes into the next row, or past the frame. The port
//     converts every column with the same arithmetic.
//     With its SIMD off (av_force_cpu_flags(0)) libswscale's C converter
//     reads chroma row y & ~1 instead; this box and the card's machine both
//     take the SIMD route.
//   * yuv422p / yuvj422p at an odd height: the generic scaled path. At 1:1
//     both scalers are the identity (15-bit samples, Y << 7), and the RGB24
//     packer (output.c yuv2rgb_1_c_template) looks each pixel pair up in
//     the tables of ff_yuv2rgb_c_init_tables: one U, V a pair,
//     r = table_rV[V][Y], g = table_gU[U][Y + gV[V]], b = table_bU[U][Y].
//   * yuv444p / yuvj444p at any height: chroma that is not subsampled makes
//     libswscale force SWS_FULL_CHR_H_INT, so the full-chroma packer
//     (yuv2rgb_write_full) computes each pixel in 32-bit integers,
//       Y' = (4 (Y << 7) - yOffset9) * yCoeff + (1 << 21),
//       B  = Y' + 4 ((U << 7) - (128 << 7)) * u2bCoeff, ...
//     with unsigned arithmetic that wraps: when any of R, G, B has bit 30
//     or 31 set all three are clipped to 0..2^30 - 1, so a sum past 2^31
//     reads as negative and clips to 0 (Y 238, U 254: blue 0 where BT.601
//     gives 255). The channel is the value >> 22.
// gray -> rgb24 copies the sample into the three channels (full range, no
// expansion); bgr0, bgra, bgr24 and 0rgb -> rgb24 reorder bytes.
// An odd output width makes libswscale force SWS_FULL_CHR_H_INT too: 4:2:2
// at an odd width and an odd height then upsamples chroma with its bilinear
// filter before the full-chroma packer. That form is not rebuilt
// (sws_takes refuses it; ROADMAP.md Queue 1 item 8b).
//
// The coefficients are ff_yuv2rgb_coeffs[SWS_CS_DEFAULT] (ITU-R BT.601:
// 104597, 132201, 25675, 53279 in 16.16), scaled by 255/219 in luma at
// limited range and by 224/255 in chroma at full range (yuvj*), C integer
// division, then rounded to 16 bits by roundToInt16.

#include <cstdint>
#include <cstring>

#include "video.h"

namespace video {
namespace {

inline int tdiv(int64_t a, int64_t b) { return int(a / b); }  // C's truncation

inline int16_t round_to_int16(int64_t f) {
  int r = int((f + (1 << 15)) >> 16);
  if (r < -0x7fff) return int16_t(-0x8000);
  if (r > 0x7fff) return 0x7fff;
  return int16_t(r);
}

inline uint8_t clip8(int v) { return uint8_t(v < 0 ? 0 : (v > 255 ? 255 : v)); }
inline int sat16(int v) { return v < -32768 ? -32768 : (v > 32767 ? 32767 : v); }

struct Coeffs {
  // the SIMD converter's and the full-chroma packer's 16-bit coefficients
  int y, vr, ub, vg, ug, y_off3, y_off9;
  // the table packer's: the luma table and the chroma steps scaled by cy
  int64_t crv, cbu, cgu, cgv;
  int yoffs;
  uint8_t ytab[2048];
};

Coeffs make_coeffs(bool full) {
  Coeffs k;
  int64_t crv = 104597, cbu = 132201, cgu = -25675, cgv = -53279;
  int64_t cy = 1 << 16, oy = 0;
  if (!full) {
    cy = tdiv(cy * 255, 219);
    oy = 16 << 16;
  } else {
    crv = tdiv(crv * 224, 255);
    cbu = tdiv(cbu * 224, 255);
    cgu = tdiv(cgu * 224, 255);
    cgv = tdiv(cgv * 224, 255);
  }
  k.y = round_to_int16(cy * (1 << 13));
  k.vr = round_to_int16(crv * (1 << 13));
  k.ub = round_to_int16(cbu * (1 << 13));
  k.vg = round_to_int16(cgv * (1 << 13));
  k.ug = round_to_int16(cgu * (1 << 13));
  k.y_off3 = round_to_int16(oy * (1 << 3));
  k.y_off9 = round_to_int16(oy * (1 << 9));
  k.crv = tdiv(crv * 65536 + 0x8000, cy);
  k.cbu = tdiv(cbu * 65536 + 0x8000, cy);
  k.cgu = tdiv(cgu * 65536 + 0x8000, cy);
  k.cgv = tdiv(cgv * 65536 + 0x8000, cy);
  // YUVRGB_TABLE_LUMA_HEADROOM 512: 1024 + 2 * 512 entries
  k.yoffs = (full ? 384 : 326) + 512;
  int64_t yb = -(int64_t(384) << 16) - 512 * cy - oy;
  for (int i = 0; i < 2048; i++, yb += cy) k.ytab[i] = clip8(int((yb + 0x8000) >> 16));
  return k;
}

const Coeffs& coeffs(bool full) {
  static const Coeffs lim = make_coeffs(false), fr = make_coeffs(true);
  return full ? fr : lim;
}

// the unscaled x86 converter, 4:2:2 at an even height
void yuv422_simd(const Picture& p, const Coeffs& k, uint8_t* dst) {
  for (int y = 0; y < p.height; y++) {
    const uint8_t* yp = p.y.data() + size_t(y) * p.stride_y;
    const uint8_t* up = p.u.data() + size_t(y) * p.stride_c;
    const uint8_t* vp = p.v.data() + size_t(y) * p.stride_c;
    uint8_t* d = dst + size_t(y) * p.width * 3;
    for (int x = 0; x < p.width; x++) {
      const int ys = ((8 * yp[x] - k.y_off3) * k.y) >> 16;
      const int u = 8 * up[x >> 1] - 1024, v = 8 * vp[x >> 1] - 1024;
      const int g = sat16(((u * k.ug) >> 16) + ((v * k.vg) >> 16));
      d[3 * x + 0] = clip8(sat16(ys + ((v * k.vr) >> 16)));
      d[3 * x + 1] = clip8(sat16(ys + g));
      d[3 * x + 2] = clip8(sat16(ys + ((u * k.ub) >> 16)));
    }
  }
}

// fill_table / fill_gv_table: the offset into the luma table of chroma c
inline int table_offset(int64_t inc, int c) { return int(-(inc >> 9) + ((int64_t(c) * inc) >> 16)); }

// the generic path's table packer, 4:2:2 at an odd height
void yuv422_tables(const Picture& p, const Coeffs& k, uint8_t* dst) {
  const uint8_t* t = k.ytab + k.yoffs;
  for (int y = 0; y < p.height; y++) {
    const uint8_t* yp = p.y.data() + size_t(y) * p.stride_y;
    const uint8_t* up = p.u.data() + size_t(y) * p.stride_c;
    const uint8_t* vp = p.v.data() + size_t(y) * p.stride_c;
    uint8_t* d = dst + size_t(y) * p.width * 3;
    for (int x = 0; x < p.width; x++) {
      const int U = up[x >> 1], V = vp[x >> 1], Y = yp[x];
      d[3 * x + 0] = t[table_offset(k.crv, V) + Y];
      d[3 * x + 1] = t[table_offset(k.cgu, U) + table_offset(k.cgv, V) + Y];
      d[3 * x + 2] = t[table_offset(k.cbu, U) + Y];
    }
  }
}

// the full-chroma packer, 4:4:4
void yuv444_full(const Picture& p, const Coeffs& k, uint8_t* dst) {
  for (int y = 0; y < p.height; y++) {
    const uint8_t* yp = p.y.data() + size_t(y) * p.stride_y;
    const uint8_t* up = p.u.data() + size_t(y) * p.stride_c;
    const uint8_t* vp = p.v.data() + size_t(y) * p.stride_c;
    uint8_t* d = dst + size_t(y) * p.width * 3;
    for (int x = 0; x < p.width; x++) {
      const int Y = ((yp[x] << 7) * 4 - k.y_off9) * k.y + (1 << 21);
      const int U = ((up[x] << 7) - (128 << 7)) * 4, V = ((vp[x] << 7) - (128 << 7)) * 4;
      int R = int(uint32_t(Y) + uint32_t(V) * uint32_t(k.vr));
      int G = int(uint32_t(Y) + uint32_t(V) * uint32_t(k.vg) + uint32_t(U) * uint32_t(k.ug));
      int B = int(uint32_t(Y) + uint32_t(U) * uint32_t(k.ub));
      if ((R | G | B) & 0xC0000000) {
        auto clip30 = [](int a) { return a < 0 ? 0 : (a > (1 << 30) - 1 ? (1 << 30) - 1 : a); };
        R = clip30(R);
        G = clip30(G);
        B = clip30(B);
      }
      d[3 * x + 0] = uint8_t(R >> 22);
      d[3 * x + 1] = uint8_t(G >> 22);
      d[3 * x + 2] = uint8_t(B >> 22);
    }
  }
}

}  // namespace

bool sws_takes(int format, int width, int height) {
  if (format == kYuv422p) return !(width & 1) || !(height & 1);
  return format == kYuv444p || format == kGray8 || format == kBgr0 || format == kBgra ||
         format == kBgr24 || format == k0rgb;
}

void sws_rgb(const Picture& p, bool full_range, uint8_t* dst) {
  const int w = p.width, h = p.height;
  switch (p.format) {
    case kYuv422p:
      if (h % 2 == 0) yuv422_simd(p, coeffs(full_range), dst);
      else yuv422_tables(p, coeffs(full_range), dst);
      return;
    case kYuv444p:
      yuv444_full(p, coeffs(full_range), dst);
      return;
    case kGray8:
      for (int y = 0; y < h; y++) {
        const uint8_t* s = p.y.data() + size_t(y) * p.stride_y;
        uint8_t* d = dst + size_t(y) * w * 3;
        for (int x = 0; x < w; x++) d[3 * x] = d[3 * x + 1] = d[3 * x + 2] = s[x];
      }
      return;
    default: {
      // packed: the byte of R, G and B within a pixel of ``step`` bytes
      int step = 4, r = 2, g = 1, b = 0;
      if (p.format == kBgr24) step = 3;
      else if (p.format == k0rgb) r = 1, g = 2, b = 3;
      for (int y = 0; y < h; y++) {
        const uint8_t* s = p.y.data() + size_t(y) * p.stride_y;
        uint8_t* d = dst + size_t(y) * w * 3;
        for (int x = 0; x < w; x++, s += step) {
          d[3 * x + 0] = s[r];
          d[3 * x + 1] = s[g];
          d[3 * x + 2] = s[b];
        }
      }
    }
  }
}

}  // namespace video

extern "C" {

// One picture of ``format`` (video::PixFmt) through the rebuild, for the
// tests: planes[0..2] with their strides (a packed format uses planes[0]);
// ``full`` selects the yuvj* forms. Returns 0, or -1 for a format it does
// not take.
int dali_tpu_torch_sws_rgb(int format, int full, int w, int h, const unsigned char* const* planes,
                           const int* strides, unsigned char* dst) {
  if (w <= 0 || h <= 0 || !video::sws_takes(format, w, h)) return -1;
  video::Picture p;
  p.format = format;
  p.width = w;
  p.height = h;
  const bool planar = format == video::kYuv422p || format == video::kYuv444p;
  const int cw = format == video::kYuv422p ? (w + 1) / 2 : w;
  const int row = planar || format == video::kGray8 ? w : (format == video::kBgr24 ? 3 : 4) * w;
  p.stride_y = strides[0];
  p.y.assign(planes[0], planes[0] + size_t(strides[0]) * (h - 1) + row);
  if (planar) {
    p.stride_c = strides[1];
    p.u.assign(planes[1], planes[1] + size_t(strides[1]) * (h - 1) + cw);
    p.v.assign(planes[2], planes[2] + size_t(strides[2]) * (h - 1) + cw);
  }
  video::sws_rgb(p, full != 0, dst);
  return 0;
}

}  // extern "C"
