// Affine warp of one HWC image on the host, equal to cv2.warpAffine (OpenCV
// 5.0) with WARP_INVERSE_MAP, BORDER_CONSTANT and INTER_NEAREST or
// INTER_LINEAR, without OpenCV: the cpu WarpAffine and Rotate of
// dali_tpu_torch (dali_tpu's call cv2 there, dali_tpu/backend/warp.py).
//
// OpenCV takes one of two routes, and this file follows each:
//
// * uint8, uint16 and float32 images of 1, 3 or 4 channels (the float
//   route): the matrix rounded to float; per row mx = y*M1 + M2 (a product
//   and a sum, each rounded); columns in blocks of 16 (OpenCV's SIMD width
//   on AVX2 hosts) take sx = fma(x, M0, mx), the columns after the last
//   whole block sx = fma(x, M0, y*M1) + M2 (OpenCV's scalar tail); likewise
//   sy. Nearest: the pixel at rint(sx), rint(sy). Linear: ix = floor(sx),
//   ax = sx - ix; v0 = fma(ax, p01 - p00, p00), v1 = fma(ax, p11 - p10, p10),
//   v = fma(ay, v1 - v0, v0); integers round half to even and saturate.
// * every other type or channel count (the fixed-point route): coordinates
//   in 1/1024 (AB_BITS 10): per column rint(M0*x*1024), per row
//   rint((M1*y + M2)*1024) + a rounding delta (512 nearest, 16 linear), in
//   double; nearest takes the pixel at the sum >> 10; linear keeps 5
//   fraction bits (INTER_BITS) and weights from a 32x32 table of products
//   (1 - i/32 or i/32) * (1 - j/32 or j/32): for 8-bit images the products
//   times 32768 as integers, (sum + 16384) >> 15 saturated; for 16-bit and
//   float images the float products, ((v0 w0 + v1 w1) + v2 w2) + v3 w3,
//   16-bit rounded half to even.
//
// A tap outside the image takes the border value (the fill, rounded and
// saturated for integer types); a linear output whose four taps are all
// outside is the border value. Compiled with -ffp-contract=off: every fused
// multiply-add here is written out.

#include <cmath>
#include <cstddef>
#include <cstdint>
#include <type_traits>
#include <vector>

namespace {

enum DType { kU8 = 0, kU16 = 1, kI16 = 2, kF32 = 3, kF64 = 4, kI8 = 5, kI32 = 6 };

// OpenCV's cvRound / cvFloor: to nearest even (floor), INT_MIN when out of
// range, as x86's conversions give.
int round_int(double v) {
  const double r = std::nearbyint(v);
  return r >= -2147483648.0 && r <= 2147483647.0 ? static_cast<int>(r) : INT32_MIN;
}

int floor_int(float v) {
  const float r = std::floor(v);
  return r >= -2147483648.0f && r < 2147483648.0f ? static_cast<int>(r) : INT32_MIN;
}

template <typename T>
struct Limits;
template <>
struct Limits<uint8_t> {
  static constexpr double lo = 0, hi = 255;
};
template <>
struct Limits<uint16_t> {
  static constexpr double lo = 0, hi = 65535;
};
template <>
struct Limits<int16_t> {
  static constexpr double lo = -32768, hi = 32767;
};
template <>
struct Limits<int8_t> {
  static constexpr double lo = -128, hi = 127;
};
template <>
struct Limits<int32_t> {
  static constexpr double lo = -2147483648.0, hi = 2147483647.0;
};

// saturate_cast<T>(v): round half to even and clamp for integers
template <typename T>
T saturate(double v) {
  if constexpr (std::is_floating_point<T>::value) {
    return static_cast<T>(v);
  } else {
    const double r = std::nearbyint(v);
    return static_cast<T>(r < Limits<T>::lo   ? Limits<T>::lo
                          : r > Limits<T>::hi ? Limits<T>::hi
                                              : r);
  }
}

template <typename T>
void warp_float_route(const T* src, int H, int W, int C, T* dst, int oh, int ow, const double* dM,
                      bool nearest, T border) {
  float M[6];
  for (int i = 0; i < 6; ++i) M[i] = static_cast<float>(dM[i]);
  const int vec_end = ow / 16 * 16;
  for (int y = 0; y < oh; ++y) {
    const float yf = static_cast<float>(y);
    const float ym1 = yf * M[1], ym4 = yf * M[4];
    const float mx = ym1 + M[2], my = ym4 + M[5];
    T* out = dst + static_cast<size_t>(y) * ow * C;
    for (int x = 0; x < ow; ++x, out += C) {
      const float xf = static_cast<float>(x);
      float sx, sy;
      if (x < vec_end) {
        sx = std::fmaf(xf, M[0], mx);
        sy = std::fmaf(xf, M[3], my);
      } else {
        sx = std::fmaf(xf, M[0], ym1) + M[2];
        sy = std::fmaf(xf, M[3], ym4) + M[5];
      }
      if (nearest) {
        const int ix = round_int(sx), iy = round_int(sy);
        const bool in = ix >= 0 && ix < W && iy >= 0 && iy < H;
        const T* p = src + (static_cast<size_t>(iy) * W + ix) * C;
        for (int c = 0; c < C; ++c) out[c] = in ? p[c] : border;
        continue;
      }
      const int ix = floor_int(sx), iy = floor_int(sy);
      const float ax = sx - static_cast<float>(ix), ay = sy - static_cast<float>(iy);
      const float b = static_cast<float>(border);
      auto at = [&](long long yy, long long xx, int c) {
        return yy >= 0 && yy < H && xx >= 0 && xx < W
                   ? static_cast<float>(src[(yy * W + xx) * C + c]) : b;
      };
      for (int c = 0; c < C; ++c) {
        const float p00 = at(iy, ix, c), p01 = at(iy, ix + 1LL, c);
        const float p10 = at(iy + 1LL, ix, c), p11 = at(iy + 1LL, ix + 1LL, c);
        const float v0 = std::fmaf(ax, p01 - p00, p00);
        const float v1 = std::fmaf(ax, p11 - p10, p10);
        out[c] = saturate<T>(std::fmaf(ay, v1 - v0, v0));
      }
    }
  }
}

// the linear weights of fraction (fy, fx) in 1/32: float products and, for
// 8-bit images, the products times 32768 rounded (they sum to 32768)
struct Table {
  float f[32 * 32][4];
  int i[32 * 32][4];
  Table() {
    for (int a = 0; a < 32; ++a) {
      for (int b = 0; b < 32; ++b) {
        const float ty[2] = {1.f - a * (1.f / 32), a * (1.f / 32)};
        const float tx[2] = {1.f - b * (1.f / 32), b * (1.f / 32)};
        for (int k = 0; k < 4; ++k) {
          const float v = ty[k >> 1] * tx[k & 1];
          f[a * 32 + b][k] = v;
          i[a * 32 + b][k] = static_cast<int>(std::nearbyint(v * 32768.0f));
        }
      }
    }
  }
};

template <typename T>
void warp_fixed_route(const T* src, int H, int W, int C, T* dst, int oh, int ow, const double* M,
                      bool nearest, T border) {
  static const Table tab;
  std::vector<int> adelta(ow), bdelta(ow);
  for (int x = 0; x < ow; ++x) {
    adelta[x] = round_int(M[0] * x * 1024);
    bdelta[x] = round_int(M[3] * x * 1024);
  }
  const int delta = nearest ? 512 : 16;
  for (int y = 0; y < oh; ++y) {
    const int X0 = round_int((M[1] * y + M[2]) * 1024) + delta;
    const int Y0 = round_int((M[4] * y + M[5]) * 1024) + delta;
    T* out = dst + static_cast<size_t>(y) * ow * C;
    for (int x = 0; x < ow; ++x, out += C) {
      const int X = static_cast<int>(static_cast<unsigned>(X0) + static_cast<unsigned>(adelta[x]));
      const int Y = static_cast<int>(static_cast<unsigned>(Y0) + static_cast<unsigned>(bdelta[x]));
      // OpenCV stores the integer coordinates as int16
      auto to_short = [](int v) { return v < -32768 ? -32768 : v > 32767 ? 32767 : v; };
      if (nearest) {
        const int sx = to_short(X >> 10), sy = to_short(Y >> 10);
        const bool in = sx >= 0 && sx < W && sy >= 0 && sy < H;
        const T* p = src + (static_cast<size_t>(sy) * W + sx) * C;
        for (int c = 0; c < C; ++c) out[c] = in ? p[c] : border;
        continue;
      }
      const int sx = to_short(X >> 10), sy = to_short(Y >> 10);
      const int frac = ((Y >> 5) & 31) * 32 + ((X >> 5) & 31);
      if (sx >= W || sx + 1 < 0 || sy >= H || sy + 1 < 0) {
        for (int c = 0; c < C; ++c) out[c] = border;
        continue;
      }
      auto at = [&](int yy, int xx, int c) {
        return yy >= 0 && yy < H && xx >= 0 && xx < W
                   ? src[(static_cast<size_t>(yy) * W + xx) * C + c] : border;
      };
      for (int c = 0; c < C; ++c) {
        const T v0 = at(sy, sx, c), v1 = at(sy, sx + 1, c);
        const T v2 = at(sy + 1, sx, c), v3 = at(sy + 1, sx + 1, c);
        if constexpr (sizeof(T) == 1) {
          const int* w = tab.i[frac];
          const int s = v0 * w[0] + v1 * w[1] + v2 * w[2] + v3 * w[3];
          const int r = (s + (1 << 14)) >> 15;
          out[c] = static_cast<T>(r < Limits<T>::lo ? Limits<T>::lo
                                  : r > Limits<T>::hi ? Limits<T>::hi : r);
        } else if constexpr (std::is_same<T, double>::value) {
          const float* w = tab.f[frac];
          out[c] = v0 * static_cast<double>(w[0]) + v1 * static_cast<double>(w[1]) +
                   v2 * static_cast<double>(w[2]) + v3 * static_cast<double>(w[3]);
        } else {
          const float* w = tab.f[frac];
          const float s = static_cast<float>(v0) * w[0] + static_cast<float>(v1) * w[1] +
                          static_cast<float>(v2) * w[2] + static_cast<float>(v3) * w[3];
          out[c] = saturate<T>(s);
        }
      }
    }
  }
}

template <typename T>
int warp(const void* src, int H, int W, int C, void* dst, int oh, int ow, const double* M,
         bool nearest, double fill, bool float_route) {
  const T border = saturate<T>(fill);
  auto s = static_cast<const T*>(src);
  auto d = static_cast<T*>(dst);
  if (float_route) {
    warp_float_route<T>(s, H, W, C, d, oh, ow, M, nearest, border);
  } else {
    warp_fixed_route<T>(s, H, W, C, d, oh, ow, M, nearest, border);
  }
  return 0;
}

}  // namespace

// src [H, W, C] and dst [oh, ow, C], contiguous, of one dtype (0 uint8,
// 1 uint16, 2 int16, 3 float32, 4 float64, 5 int8, 6 int32); M the 2x3
// destination -> source matrix, row-major. Returns 0, or -1 for a form
// cv2.warpAffine refuses (linear int8 or int32) or an unknown dtype.
extern "C" int dali_tpu_torch_warp_affine(const void* src, int H, int W, int C, int dtype,
                                          void* dst, int oh, int ow, const double* M,
                                          int nearest, double fill) {
  const bool float_route =
      (dtype == kU8 || dtype == kU16 || dtype == kF32) && (C == 1 || C == 3 || C == 4);
  const bool nn = nearest != 0;
  switch (dtype) {
    case kU8:
      return warp<uint8_t>(src, H, W, C, dst, oh, ow, M, nn, fill, float_route);
    case kU16:
      return warp<uint16_t>(src, H, W, C, dst, oh, ow, M, nn, fill, float_route);
    case kI16:
      return warp<int16_t>(src, H, W, C, dst, oh, ow, M, nn, fill, false);
    case kF32:
      return warp<float>(src, H, W, C, dst, oh, ow, M, nn, fill, float_route);
    case kF64:
      return warp<double>(src, H, W, C, dst, oh, ow, M, nn, fill, false);
    case kI8:
      return nn ? warp<int8_t>(src, H, W, C, dst, oh, ow, M, true, fill, false) : -1;
    case kI32:
      return nn ? warp<int32_t>(src, H, W, C, dst, oh, ow, M, true, fill, false) : -1;
    default:
      return -1;
  }
}
