// PNG pixel stages without libpng: the counterpart of the reference's PNG
// route, cv2.imdecode with IMREAD_COLOR or IMREAD_GRAYSCALE and
// IMREAD_ANYDEPTH (OpenCV grfmt_png.cpp over libpng 1.6). Python walks the
// chunks and inflates the IDAT stream with the standard zlib module; this
// file undoes the scanline filters (0-4) of the image or of each Adam7 pass,
// then applies the transforms OpenCV asks libpng for:
//
//  * palette indices to RGB (png_set_palette_to_rgb; indices past the
//    palette give black), grey of 1, 2 or 4 bits widened to 8
//    (png_set_expand_gray_1_2_4_to_8: x255, x85, x17);
//  * alpha and tRNS dropped (png_set_strip_alpha);
//  * grey to RGB replicated (png_set_gray_to_rgb), or RGB to grey
//    (png_set_rgb_to_gray with 0.299/0.587: coefficients 9797, 19234 and
//    3737 in 1/32768; 8 bits truncate, equal channels pass through, 16 bits
//    round); where gAMA or sRGB make the file gamma significant, libpng
//    converts through its linear tables (png_do_rgb_to_gray), 8-bit or
//    16-bit (png_build_16bit_table, indexed at the precision sBIT leaves);
//  * 16-bit samples kept (IMREAD_ANYDEPTH), native byte order.
//
// Output is RGB (the caller flips it for BGR) or one grey channel, uint8, or
// uint16 for a 16-bit image.

#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <vector>

namespace {

int channels(int color_type) {
  switch (color_type) {
    case 0: return 1;
    case 2: return 3;
    case 3: return 1;
    case 4: return 2;
    case 6: return 4;
    default: return 0;
  }
}

inline int paeth(int a, int b, int c) {
  const int p = a + b - c, pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  return pa <= pb && pa <= pc ? a : pb <= pc ? b : c;
}

// libpng's fixed-point gamma helpers (png.c, floating-point build)
int64_t png_reciprocal(int64_t a) { return (int64_t)std::floor(1e10 / (double)a + .5); }
bool gamma_significant(int64_t g) { return g < 100000 - 5000 || g > 100000 + 5000; }
void build_8bit_table(int64_t g, int* t) {
  for (int i = 0; i < 256; i++)
    t[i] = (gamma_significant(g) && i > 0 && i < 255)
               ? (int)std::floor(255 * std::pow(i / 255., g * .00001) + .5)
               : i;
}

// png_build_16bit_table: (1 << (8 - shift)) tables of 256, looked up as
// t[(v & 0xff) >> shift][v >> 8].
struct Table16 {
  int shift = 0;
  std::vector<uint16_t> t;
  Table16(int64_t g, int sh) : shift(sh), t((size_t)256 << (8 - sh)) {
    const double fmax = 1.0 / ((1 << (16 - sh)) - 1);
    const unsigned max = (1u << (16 - sh)) - 1, max_by_2 = 1u << (15 - sh);
    for (unsigned i = 0; i < (1u << (8 - sh)); i++)
      for (unsigned j = 0; j < 256; j++) {
        uint32_t ig = (j << (8 - sh)) + i;
        if (gamma_significant(g))
          ig = (uint32_t)std::floor(65535. * std::pow(ig * fmax, g * .00001) + .5);
        else if (sh != 0)
          ig = (ig * 65535u + max_by_2) / max;
        t[i * 256 + j] = (uint16_t)ig;
      }
  }
  int operator()(int v) const { return t[(size_t)((v & 0xff) >> shift) * 256 + (v >> 8)]; }
};

}  // namespace

extern "C" {

// raw: the inflated IDAT stream. Writes h x w x (gray ? 1 : 3) samples to
// out (uint16 when bit_depth is 16, else uint8). gamma: the file gamma in
// 1/100000 (0: none); sig_bit: the largest colour sBIT value (0: none).
// Returns 0, or -1 for too little image data or a bad filter type (libpng
// fails).
int dali_tpu_torch_png_decode(const uint8_t* raw, size_t raw_len, int w, int h, int bit_depth,
                              int color_type, int interlace, const uint8_t* plte, int plte_n,
                              int gamma, int sig_bit, int gray, void* out) {
  const int ch = channels(color_type);
  if (ch == 0 || w <= 0 || h <= 0) return -1;
  const int bd = bit_depth;
  const bool colour = color_type == 2 || color_type == 3 || color_type == 6;
  const bool sig_gamma = gamma > 0 && gamma_significant(gamma);
  // 1. unfilter into samples at the file's bit depth
  std::vector<uint16_t> samp((size_t)w * h * ch);
  static const int kAdam7[7][4] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8}, {2, 0, 4, 4},
                                   {0, 2, 2, 4}, {1, 0, 2, 2}, {0, 1, 1, 2}};
  static const int kWhole[1][4] = {{0, 0, 1, 1}};
  const int (*passes)[4] = interlace ? kAdam7 : kWhole;
  const int npass = interlace ? 7 : 1;
  const int bpp = std::max(1, ch * bd / 8);  // filter distance in bytes
  size_t off = 0;
  std::vector<uint8_t> prev, cur;
  for (int p = 0; p < npass; p++) {
    const int x0 = passes[p][0], y0 = passes[p][1], dx = passes[p][2], dy = passes[p][3];
    const int pw = (w - x0 + dx - 1) / dx, ph = (h - y0 + dy - 1) / dy;
    if (pw <= 0 || ph <= 0) continue;
    const size_t stride = ((size_t)pw * ch * bd + 7) / 8;
    prev.assign(stride, 0);
    cur.resize(stride);
    for (int r = 0; r < ph; r++) {
      if (off > raw_len || raw_len - off < stride + 1) return -1;
      const int ft = raw[off];
      const uint8_t* in = raw + off + 1;
      off += stride + 1;
      for (size_t i = 0; i < stride; i++) {
        const int a = i >= (size_t)bpp ? cur[i - bpp] : 0, b = prev[i];
        const int c = i >= (size_t)bpp ? prev[i - bpp] : 0;
        int v = in[i];
        switch (ft) {
          case 0: break;
          case 1: v += a; break;
          case 2: v += b; break;
          case 3: v += (a + b) >> 1; break;
          case 4: v += paeth(a, b, c); break;
          default: return -1;
        }
        cur[i] = (uint8_t)v;
      }
      uint16_t* row = samp.data() + ((size_t)(y0 + r * dy) * w + x0) * ch;
      for (int x = 0; x < pw; x++) {
        uint16_t* px = row + (size_t)x * dx * ch;
        for (int k = 0; k < ch; k++) {
          const size_t s = (size_t)x * ch + k;
          if (bd == 16) {
            px[k] = (uint16_t)(cur[2 * s] << 8 | cur[2 * s + 1]);
          } else if (bd == 8) {
            px[k] = cur[s];
          } else {
            const size_t bit = s * bd;
            px[k] = (uint16_t)((cur[bit >> 3] >> (8 - bd - (bit & 7))) & ((1 << bd) - 1));
          }
        }
      }
      std::swap(prev, cur);
    }
  }
  // 2. libpng's transforms, as OpenCV sets them up
  int to1[256], from1[256];
  const bool gamma16 = sig_gamma && gray && colour && bd == 16;
  const int shift = std::min(sig_bit > 0 && sig_bit < 16 ? 16 - sig_bit : 0, 8);
  const Table16 to16(gamma16 ? png_reciprocal(gamma) : 100000, gamma16 ? shift : 0);
  const Table16 from16(gamma16 ? png_reciprocal(png_reciprocal(gamma)) : 100000,
                       gamma16 ? shift : 0);
  // gamma_16_table: file gamma x screen gamma is 1, so it only rescales
  // the bits sBIT marks significant (equal channels pass through it)
  const Table16 same16(100000, gamma16 ? shift : 0);
  if (sig_gamma) {
    build_8bit_table(png_reciprocal(gamma), to1);
    build_8bit_table(png_reciprocal(png_reciprocal(gamma)), from1);
  }
  const int widen = color_type == 0 && bd < 8 ? 255 / ((1 << bd) - 1) : 1;
  uint8_t* o8 = static_cast<uint8_t*>(out);
  uint16_t* o16 = static_cast<uint16_t*>(out);
  for (size_t i = 0; i < (size_t)w * h; i++) {
    const uint16_t* s = samp.data() + i * ch;
    int r, g, b;
    if (color_type == 3) {
      const int k = s[0];
      r = k < plte_n ? plte[3 * k] : 0;
      g = k < plte_n ? plte[3 * k + 1] : 0;
      b = k < plte_n ? plte[3 * k + 2] : 0;
    } else if (colour) {
      r = s[0];
      g = s[1];
      b = s[2];
    } else {
      r = g = b = s[0] * widen;
    }
    if (gray) {
      int v = r;
      if (colour) {
        if (gamma16)
          v = r == g && r == b ? same16(r)
                               : from16((int)((9797LL * to16(r) + 19234LL * to16(g) +
                                               3737LL * to16(b) + 16384) >> 15));
        else if (bd == 16)
          v = (int)((9797LL * r + 19234LL * g + 3737LL * b + 16384) >> 15);
        else if (r != g || r != b)
          v = sig_gamma ? from1[(9797 * to1[r] + 19234 * to1[g] + 3737 * to1[b] + 16384) >> 15]
                        : (9797 * r + 19234 * g + 3737 * b) >> 15;
      }
      if (bd == 16) o16[i] = (uint16_t)v;
      else o8[i] = (uint8_t)v;
    } else if (bd == 16) {
      o16[3 * i] = (uint16_t)r;
      o16[3 * i + 1] = (uint16_t)g;
      o16[3 * i + 2] = (uint16_t)b;
    } else {
      o8[3 * i] = (uint8_t)r;
      o8[3 * i + 1] = (uint8_t)g;
      o8[3 * i + 2] = (uint8_t)b;
    }
  }
  return 0;
}

}  // extern "C"
