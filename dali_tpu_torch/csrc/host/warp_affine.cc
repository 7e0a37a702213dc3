// Warps of one HWC image on the host, equal to OpenCV 5.0's cv2.warpAffine
// and cv2.warpPerspective (WARP_INVERSE_MAP) and cv2.remap (two float32
// maps), INTER_NEAREST or INTER_LINEAR, BORDER_CONSTANT or BORDER_REPLICATE,
// without OpenCV: the cpu WarpAffine, Rotate, experimental.WarpPerspective
// and experimental.Remap of dali_tpu_torch (dali_tpu's call cv2 there,
// dali_tpu/backend/warp.py, parity.py, misc2.py).
//
// OpenCV takes one of two routes, and this file follows each:
//
// * uint8, uint16 and float32 images of 1, 3 or 4 channels (the float
//   route): the matrix rounded to float. Affine: per row mx = y*M1 + M2 (a
//   product and a sum, each rounded); columns in blocks of 16 (OpenCV's SIMD
//   width on AVX2 hosts) take sx = fma(x, M0, mx), the columns after the
//   last whole block sx = fma(x, M0, y*M1) + M2 (OpenCV's scalar tail);
//   likewise sy. Perspective: the same for the numerators and for
//   w = fma(x, M6, y*M7 + M8) (tail fma(x, M6, y*M7) + M8), then sx = num/w.
//   Remap: sx and sy are the maps' values. Nearest: the pixel at rint(sx),
//   rint(sy). Linear: ix = floor(sx), ax = sx - ix;
//   v0 = fma(ax, p01 - p00, p00), v1 = fma(ax, p11 - p10, p10),
//   v = fma(ay, v1 - v0, v0); integers round half to even and saturate.
// * every other type or channel count (the fixed-point route): integer
//   coordinates with 5 fraction bits (INTER_BITS) for linear. Affine:
//   coordinates in 1/1024 (AB_BITS 10): per column rint(M0*x*1024), per row
//   rint((M1*y + M2)*1024) + a rounding delta (512 nearest, 16 linear), in
//   double, the sum >> 10 (nearest) or >> 5 (linear). Perspective (in
//   double, over blocks of columns of OpenCV's block size): per block start
//   xb and row y, X0 = M0*xb + M1*y + M2 (likewise Y0, W0), per column
//   x1 = x - xb, W = W0 + M6*x1, and rint((X0 + M0*x1) * k/W), k 1 (nearest)
//   or 32 (linear). Remap: rint(sx) (nearest) or rint(sx*32) in float. The
//   pixel (the sum >> 5 for linear) is saturated to int16. Linear weights
//   come from a 32x32 table of products (1 - i/32 or i/32) * (1 - j/32 or
//   j/32): for 8-bit images the products times 32768 as integers,
//   (sum + 16384) >> 15 saturated; for 16-bit and float images the float
//   products, ((v0 w0 + v1 w1) + v2 w2) + v3 w3, 16-bit rounded half to even.
//
// BORDER_CONSTANT: a tap outside the image takes the border value (the
// fill, rounded and saturated for integer types), and a linear output whose
// four taps are all outside is the border value. BORDER_REPLICATE: each tap
// clamps to the image. Compiled with -ffp-contract=off: every fused
// multiply-add here is written out.

#include <algorithm>
#include <climits>
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

int round_int(float v) {
  const float r = std::nearbyint(v);
  return r >= -2147483648.0f && r < 2147483648.0f ? static_cast<int>(r) : INT32_MIN;
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

inline int to_short(int v) { return v < -32768 ? -32768 : v > 32767 ? 32767 : v; }
inline int clampi(long long v, int n) { return static_cast<int>(v < 0 ? 0 : v >= n ? n - 1 : v); }

// One image and its border: the pixel arithmetic of both routes.
template <typename T>
struct Sampler {
  const T* src;
  int H, W, C;
  bool replicate;
  T border;

  const T* at(long long y, long long x) const {
    return src + (static_cast<size_t>(y) * W + static_cast<size_t>(x)) * C;
  }

  // the float route at (sx, sy)
  void float_pixel(float sx, float sy, bool nearest, T* out) const {
    if (nearest) {
      long long ix = round_int(sx), iy = round_int(sy);
      if (replicate) {
        ix = clampi(ix, W);
        iy = clampi(iy, H);
      }
      const bool in = ix >= 0 && ix < W && iy >= 0 && iy < H;
      for (int c = 0; c < C; ++c) out[c] = in ? at(iy, ix)[c] : border;
      return;
    }
    const int ix = floor_int(sx), iy = floor_int(sy);
    const float ax = sx - static_cast<float>(ix), ay = sy - static_cast<float>(iy);
    const float b = static_cast<float>(border);
    auto tap = [&](long long yy, long long xx, int c) {
      if (replicate) return static_cast<float>(at(clampi(yy, H), clampi(xx, W))[c]);
      return yy >= 0 && yy < H && xx >= 0 && xx < W ? static_cast<float>(at(yy, xx)[c]) : b;
    };
    for (int c = 0; c < C; ++c) {
      const float p00 = tap(iy, ix, c), p01 = tap(iy, ix + 1LL, c);
      const float p10 = tap(iy + 1LL, ix, c), p11 = tap(iy + 1LL, ix + 1LL, c);
      const float v0 = std::fmaf(ax, p01 - p00, p00);
      const float v1 = std::fmaf(ax, p11 - p10, p10);
      out[c] = saturate<T>(std::fmaf(ay, v1 - v0, v0));
    }
  }

  // the fixed route: the pixel (sx, sy), int16 as OpenCV stores it
  void fixed_nearest(int sx, int sy, T* out) const {
    sx = to_short(sx);
    sy = to_short(sy);
    if (replicate) {
      sx = clampi(sx, W);
      sy = clampi(sy, H);
    }
    const bool in = sx >= 0 && sx < W && sy >= 0 && sy < H;
    for (int c = 0; c < C; ++c) out[c] = in ? at(sy, sx)[c] : border;
  }

  // the fixed route: top-left tap (sx, sy), frac = fy * 32 + fx
  void fixed_linear(int sx, int sy, int frac, T* out) const {
    static const Table tab;
    sx = to_short(sx);
    sy = to_short(sy);
    if (!replicate && (sx >= W || sx + 1 < 0 || sy >= H || sy + 1 < 0)) {
      for (int c = 0; c < C; ++c) out[c] = border;
      return;
    }
    auto tap = [&](int yy, int xx, int c) {
      if (replicate) return at(clampi(yy, H), clampi(xx, W))[c];
      return yy >= 0 && yy < H && xx >= 0 && xx < W ? at(yy, xx)[c] : border;
    };
    for (int c = 0; c < C; ++c) {
      const T v0 = tap(sy, sx, c), v1 = tap(sy, sx + 1, c);
      const T v2 = tap(sy + 1, sx, c), v3 = tap(sy + 1, sx + 1, c);
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

  // the fixed route's linear sample at coordinates X, Y in 1/32
  void fixed_linear32(int X, int Y, T* out) const {
    fixed_linear(X >> 5, Y >> 5, (Y & 31) * 32 + (X & 31), out);
  }
};

// The columns OpenCV's SIMD loop covers: whole blocks of 16.
inline int vec_end(int ow) { return ow / 16 * 16; }

template <typename T>
void affine(const Sampler<T>& s, T* dst, int oh, int ow, const double* M, bool nearest,
            bool float_route) {
  if (float_route) {
    float m[6];
    for (int i = 0; i < 6; ++i) m[i] = static_cast<float>(M[i]);
    const int ve = vec_end(ow);
    for (int y = 0; y < oh; ++y) {
      const float yf = static_cast<float>(y);
      const float ym1 = yf * m[1], ym4 = yf * m[4];
      const float mx = ym1 + m[2], my = ym4 + m[5];
      T* out = dst + static_cast<size_t>(y) * ow * s.C;
      for (int x = 0; x < ow; ++x, out += s.C) {
        const float xf = static_cast<float>(x);
        const float sx = x < ve ? std::fmaf(xf, m[0], mx) : std::fmaf(xf, m[0], ym1) + m[2];
        const float sy = x < ve ? std::fmaf(xf, m[3], my) : std::fmaf(xf, m[3], ym4) + m[5];
        s.float_pixel(sx, sy, nearest, out);
      }
    }
    return;
  }
  std::vector<int> adelta(ow), bdelta(ow);
  for (int x = 0; x < ow; ++x) {
    adelta[x] = round_int(M[0] * x * 1024);
    bdelta[x] = round_int(M[3] * x * 1024);
  }
  const int delta = nearest ? 512 : 16;
  for (int y = 0; y < oh; ++y) {
    const int X0 = round_int((M[1] * y + M[2]) * 1024) + delta;
    const int Y0 = round_int((M[4] * y + M[5]) * 1024) + delta;
    T* out = dst + static_cast<size_t>(y) * ow * s.C;
    for (int x = 0; x < ow; ++x, out += s.C) {
      const int X = static_cast<int>(static_cast<unsigned>(X0) + static_cast<unsigned>(adelta[x]));
      const int Y = static_cast<int>(static_cast<unsigned>(Y0) + static_cast<unsigned>(bdelta[x]));
      if (nearest) {
        s.fixed_nearest(X >> 10, Y >> 10, out);
      } else {
        s.fixed_linear32(X >> 5, Y >> 5, out);
      }
    }
  }
}

// saturate_cast<int>(double) of a value clamped to the int range
inline int clamp_round(double v) {
  return round_int(std::max(static_cast<double>(INT_MIN), std::min(static_cast<double>(INT_MAX), v)));
}

template <typename T>
void perspective(const Sampler<T>& s, T* dst, int oh, int ow, const double* M, bool nearest,
                 bool float_route) {
  if (float_route) {
    float m[9];
    for (int i = 0; i < 9; ++i) m[i] = static_cast<float>(M[i]);
    const int ve = vec_end(ow);
    for (int y = 0; y < oh; ++y) {
      const float yf = static_cast<float>(y);
      const float ym1 = yf * m[1], ym4 = yf * m[4], ym7 = yf * m[7];
      const float mx = ym1 + m[2], my = ym4 + m[5], mw = ym7 + m[8];
      T* out = dst + static_cast<size_t>(y) * ow * s.C;
      for (int x = 0; x < ow; ++x, out += s.C) {
        const float xf = static_cast<float>(x);
        float nx, ny, w;
        if (x < ve) {
          nx = std::fmaf(xf, m[0], mx);
          ny = std::fmaf(xf, m[3], my);
          w = std::fmaf(xf, m[6], mw);
        } else {
          nx = std::fmaf(xf, m[0], ym1) + m[2];
          ny = std::fmaf(xf, m[3], ym4) + m[5];
          w = std::fmaf(xf, m[6], ym7) + m[8];
        }
        s.float_pixel(nx / w, ny / w, nearest, out);
      }
    }
    return;
  }
  // OpenCV's block of output columns (WarpPerspectiveInvoker, BLOCK_SZ 32)
  int bh0 = std::min(16, oh);
  const int bw0 = std::min(1024 / bh0, ow);
  const double k = nearest ? 1.0 : 32.0;
  for (int y = 0; y < oh; ++y) {
    T* out = dst + static_cast<size_t>(y) * ow * s.C;
    for (int xb = 0; xb < ow; xb += bw0) {
      const double X0 = M[0] * xb + M[1] * y + M[2];
      const double Y0 = M[3] * xb + M[4] * y + M[5];
      const double W0 = M[6] * xb + M[7] * y + M[8];
      const int bw = std::min(bw0, ow - xb);
      for (int x1 = 0; x1 < bw; ++x1, out += s.C) {
        double Wd = W0 + M[6] * x1;
        Wd = Wd ? k / Wd : 0;
        const int X = clamp_round((X0 + M[0] * x1) * Wd);
        const int Y = clamp_round((Y0 + M[3] * x1) * Wd);
        if (nearest) {
          s.fixed_nearest(X, Y, out);
        } else {
          s.fixed_linear32(X, Y, out);
        }
      }
    }
  }
}

template <typename T>
void remap(const Sampler<T>& s, T* dst, int oh, int ow, const float* mx, const float* my,
           bool nearest, bool float_route) {
  const size_t n = static_cast<size_t>(oh) * ow;
  for (size_t i = 0; i < n; ++i) {
    T* out = dst + i * s.C;
    if (float_route) {
      s.float_pixel(mx[i], my[i], nearest, out);
    } else if (nearest) {
      s.fixed_nearest(round_int(mx[i]), round_int(my[i]), out);
    } else {
      s.fixed_linear32(round_int(mx[i] * 32.0f), round_int(my[i] * 32.0f), out);
    }
  }
}

// kind 0 affine (M 2x3), 1 perspective (M 3x3), 2 remap (maps mx, my)
template <typename T>
int warp(int kind, const void* src, int H, int W, int C, void* dst, int oh, int ow,
         const double* M, const float* mx, const float* my, bool nearest, bool replicate,
         double fill, bool float_route) {
  const Sampler<T> s{static_cast<const T*>(src), H, W, C, replicate, saturate<T>(fill)};
  auto d = static_cast<T*>(dst);
  if (kind == 0) {
    affine<T>(s, d, oh, ow, M, nearest, float_route);
  } else if (kind == 1) {
    perspective<T>(s, d, oh, ow, M, nearest, float_route);
  } else {
    remap<T>(s, d, oh, ow, mx, my, nearest, float_route);
  }
  return 0;
}

int dispatch(int kind, const void* src, int H, int W, int C, int dtype, void* dst, int oh,
             int ow, const double* M, const float* mx, const float* my, int nearest,
             int replicate, double fill) {
  const bool float_route =
      (dtype == kU8 || dtype == kU16 || dtype == kF32) && (C == 1 || C == 3 || C == 4);
  const bool nn = nearest != 0, rep = replicate != 0;
  switch (dtype) {
    case kU8:
      return warp<uint8_t>(kind, src, H, W, C, dst, oh, ow, M, mx, my, nn, rep, fill, float_route);
    case kU16:
      return warp<uint16_t>(kind, src, H, W, C, dst, oh, ow, M, mx, my, nn, rep, fill,
                            float_route);
    case kI16:
      return warp<int16_t>(kind, src, H, W, C, dst, oh, ow, M, mx, my, nn, rep, fill, false);
    case kF32:
      return warp<float>(kind, src, H, W, C, dst, oh, ow, M, mx, my, nn, rep, fill, float_route);
    case kF64:
      return warp<double>(kind, src, H, W, C, dst, oh, ow, M, mx, my, nn, rep, fill, false);
    case kI8:
      return nn ? warp<int8_t>(kind, src, H, W, C, dst, oh, ow, M, mx, my, true, rep, fill, false)
                : -1;
    case kI32:
      return nn ? warp<int32_t>(kind, src, H, W, C, dst, oh, ow, M, mx, my, true, rep, fill,
                                false)
                : -1;
    default:
      return -1;
  }
}

}  // namespace

// src [H, W, C] and dst [oh, ow, C], contiguous, of one dtype (0 uint8,
// 1 uint16, 2 int16, 3 float32, 4 float64, 5 int8, 6 int32). Each returns 0,
// or -1 for a form OpenCV refuses (linear int8 or int32) or an unknown dtype.

// M: the 2x3 destination -> source matrix, row-major; constant border.
extern "C" int dali_tpu_torch_warp_affine(const void* src, int H, int W, int C, int dtype,
                                          void* dst, int oh, int ow, const double* M,
                                          int nearest, double fill) {
  return dispatch(0, src, H, W, C, dtype, dst, oh, ow, M, nullptr, nullptr, nearest, 0, fill);
}

// M: the 3x3 destination -> source homography, row-major.
extern "C" int dali_tpu_torch_warp_perspective(const void* src, int H, int W, int C, int dtype,
                                               void* dst, int oh, int ow, const double* M,
                                               int nearest, int replicate, double fill) {
  return dispatch(1, src, H, W, C, dtype, dst, oh, ow, M, nullptr, nullptr, nearest, replicate,
                  fill);
}

// mx, my: float32 [oh, ow] source coordinates of each output pixel.
extern "C" int dali_tpu_torch_remap(const void* src, int H, int W, int C, int dtype, void* dst,
                                    int oh, int ow, const float* mx, const float* my,
                                    int nearest, int replicate, double fill) {
  return dispatch(2, src, H, W, C, dtype, dst, oh, ow, nullptr, mx, my, nearest, replicate,
                  fill);
}
