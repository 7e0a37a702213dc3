// Host image kernels of the cpu MedianBlur, Dilate/Erode, Clahe,
// GaussianBlur/Laplacian/Filter and Debayer of dali_tpu_torch: the port's
// own copy of dali_tpu's host_ops.cc entry points (median_blur_u8, morph_u8,
// clahe_f32, sep_conv_f32, filter2d_f32, debayer_bilinear_u8/u16), operation
// for operation, and OpenCV's edge-aware Bayer demosaic
// (Bayer2RGB_EdgeAware_T) below them.
//
// build.py compiles this file with dali_tpu's flags (-O3 -march=native
// -std=c++17, floating-point contraction left on) into an object of its own:
// the float kernels' sums then contract into the same fused multiply-adds
// as the reference library's, which keeps them bit-equal to it.

#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstdlib>
#include <limits>
#include <vector>

extern "C" {

// Median filter, uint8, odd k, replicate border, any channel count.
// Huang's algorithm: per (row, channel) a 256-bin histogram slides along x.
int dali_tpu_torch_median_blur_u8(const unsigned char* src, int h, int w, int c,
                            int k, unsigned char* dst) {
  if (k < 1 || (k & 1) == 0) return -1;
  const int r = k / 2;
  const int need = (k * k) / 2 + 1;  // rank of the median (1-based)
  std::vector<int> hist(256);
  for (int ch = 0; ch < c; ch++) {
    for (int y = 0; y < h; y++) {
      std::fill(hist.begin(), hist.end(), 0);
      // window at x = 0
      for (int dy = -r; dy <= r; dy++) {
        int yy = dy + y;
        yy = yy < 0 ? 0 : yy >= h ? h - 1 : yy;
        const unsigned char* row = src + ((size_t)yy * w) * c + ch;
        for (int dx = -r; dx <= r; dx++) {
          int xx = dx < 0 ? 0 : dx;  // x=0 window, replicate left
          xx = xx >= w ? w - 1 : xx;
          hist[row[(size_t)xx * c]]++;
        }
      }
      for (int x = 0; x < w; x++) {
        // median = smallest value whose cumulative count reaches `need`
        int cnt = 0, m = 0;
        for (; m < 256; m++) {
          cnt += hist[m];
          if (cnt >= need) break;
        }
        dst[((size_t)y * w + x) * c + ch] = (unsigned char)m;
        if (x + 1 < w) {  // slide: remove column x-r, add column x+1+r
          int xo = x - r;
          xo = xo < 0 ? 0 : xo;
          int xi = x + 1 + r;
          xi = xi >= w ? w - 1 : xi;
          for (int dy = -r; dy <= r; dy++) {
            int yy = dy + y;
            yy = yy < 0 ? 0 : yy >= h ? h - 1 : yy;
            const unsigned char* row = src + ((size_t)yy * w) * c + ch;
            hist[row[(size_t)xo * c]]--;
            hist[row[(size_t)xi * c]]++;
          }
        }
      }
    }
  }
  return 0;
}

}  // extern "C"

namespace {
// one separable min/max pass along x (stride cs between pixels of a row)
template <bool kDilate>
void morph_pass_1d(const unsigned char* src, unsigned char* dst, int n,
                   int stride, int win, int anchor, bool replicate) {
  const int lo_off = -anchor, hi_off = win - 1 - anchor;
  for (int i = 0; i < n; i++) {
    int lo = i + lo_off, hi = i + hi_off;
    if (replicate) {
      lo = lo < 0 ? 0 : lo;
      hi = hi >= n ? n - 1 : hi;
    } else {  // constant border = reduction identity: just skip outside
      lo = lo < 0 ? 0 : lo;
      hi = hi >= n ? n - 1 : hi;
    }
    unsigned char best = src[(size_t)lo * stride];
    for (int j = lo + 1; j <= hi; j++) {
      unsigned char v = src[(size_t)j * stride];
      if (kDilate ? (v > best) : (v < best)) best = v;
    }
    dst[(size_t)i * stride] = best;
  }
}
}  // namespace

extern "C" {

// Erode/dilate with a full-ones mh x mw structuring element (separable),
// `iterations` applications. border: 0 = constant-identity (outside pixels
// ignored), 1 = replicate (same result for full kernels).
int dali_tpu_torch_morph_u8(const unsigned char* src, int h, int w, int c, int mh,
                      int mw, int anchor_y, int anchor_x, int iterations,
                      int dilate, int replicate, unsigned char* dst) {
  if (mh < 1 || mw < 1 || iterations < 1) return -1;
  if (anchor_y < 0) anchor_y = mh / 2;
  if (anchor_x < 0) anchor_x = mw / 2;
  size_t total = (size_t)h * w * c;
  std::vector<unsigned char> tmp(total);
  const unsigned char* cur = src;
  unsigned char* a = dst;
  unsigned char* b = tmp.data();
  for (int it = 0; it < iterations; it++) {
    // rows: x pass into b
    for (int ch = 0; ch < c; ch++)
      for (int y = 0; y < h; y++) {
        const unsigned char* srow = cur + ((size_t)y * w) * c + ch;
        unsigned char* drow = b + ((size_t)y * w) * c + ch;
        if (dilate)
          morph_pass_1d<true>(srow, drow, w, c, mw, anchor_x, replicate != 0);
        else
          morph_pass_1d<false>(srow, drow, w, c, mw, anchor_x, replicate != 0);
      }
    // cols: y pass into a
    for (int ch = 0; ch < c; ch++)
      for (int x = 0; x < w; x++) {
        const unsigned char* scol = b + (size_t)x * c + ch;
        unsigned char* dcol = a + (size_t)x * c + ch;
        if (dilate)
          morph_pass_1d<true>(scol, dcol, h, w * c, mh, anchor_y,
                              replicate != 0);
        else
          morph_pass_1d<false>(scol, dcol, h, w * c, mh, anchor_y,
                               replicate != 0);
      }
    cur = a;  // iterate in place over dst
  }
  return 0;
}

// CLAHE on one float plane in [0, 255], in the operations of the gpu
// placement (backend/straggler_gpu.py _clahe_planes).
int dali_tpu_torch_clahe_f32(const float* src, int h, int w, float clip,
                       int tiles_x, int tiles_y, int bins, float* dst) {
  if (bins < 2 || (bins & (bins - 1)) != 0) return -1;
  const float th = (float)h / tiles_y, tw = (float)w / tiles_x;
  const int nt = tiles_x * tiles_y;
  std::vector<float> hist((size_t)nt * bins, 0.0f);
  const float q = (bins - 1) / 255.0f;
  for (int y = 0; y < h; y++) {
    int ty = (int)(y / th);
    ty = ty >= tiles_y ? tiles_y - 1 : ty;
    for (int x = 0; x < w; x++) {
      int tx = (int)(x / tw);
      tx = tx >= tiles_x ? tiles_x - 1 : tx;
      float pv = src[(size_t)y * w + x];
      int v = (int)std::nearbyintf(pv * q);
      v = v < 0 ? 0 : v >= bins ? bins - 1 : v;
      hist[((size_t)ty * tiles_x + tx) * bins + v] += 1.0f;
    }
  }
  const float area = th * tw;
  float lim = clip * area / bins;
  if (lim < 1.0f) lim = 1.0f;
  std::vector<float> luts((size_t)nt * bins);
  const float scale = 255.0f / (area > 1.0f ? area : 1.0f);
  for (int t = 0; t < nt; t++) {
    float* hb = hist.data() + (size_t)t * bins;
    float excess = 0.0f;
    for (int b = 0; b < bins; b++)
      if (hb[b] > lim) excess += hb[b] - lim;
    const float add = excess / bins;
    float cdf = 0.0f, cdf0 = 0.0f;
    for (int b = 0; b < bins; b++) {
      float hv = (hb[b] < lim ? hb[b] : lim) + add;
      cdf += hv;
      if (b == 0) cdf0 = cdf;
      float lv = std::nearbyintf((cdf - cdf0) * scale);
      luts[(size_t)t * bins + b] = lv < 0 ? 0 : lv > 255 ? 255 : lv;
    }
  }
  for (int y = 0; y < h; y++) {
    float fy = y / th - 0.5f;
    fy = fy < 0 ? 0 : fy > tiles_y - 1.0f ? tiles_y - 1.0f : fy;
    int y0 = (int)fy;
    float wy = fy - y0;
    int y1 = y0 + 1 >= tiles_y ? tiles_y - 1 : y0 + 1;
    for (int x = 0; x < w; x++) {
      float fx = x / tw - 0.5f;
      fx = fx < 0 ? 0 : fx > tiles_x - 1.0f ? tiles_x - 1.0f : fx;
      int x0 = (int)fx;
      float wx = fx - x0;
      int x1 = x0 + 1 >= tiles_x ? tiles_x - 1 : x0 + 1;
      float pv = src[(size_t)y * w + x];
      int v = (int)std::nearbyintf(pv * q);
      v = v < 0 ? 0 : v >= bins ? bins - 1 : v;
      float l00 = luts[((size_t)y0 * tiles_x + x0) * bins + v];
      float l01 = luts[((size_t)y0 * tiles_x + x1) * bins + v];
      float l10 = luts[((size_t)y1 * tiles_x + x0) * bins + v];
      float l11 = luts[((size_t)y1 * tiles_x + x1) * bins + v];
      dst[(size_t)y * w + x] = (1 - wy) * (1 - wx) * l00 + (1 - wy) * wx * l01 +
                               wy * (1 - wx) * l10 + wy * wx * l11;
    }
  }
  return 0;
}

}  // extern "C"

namespace {

enum Border {
  kReflect101 = 0,  // gfedcb|abcdefgh|gfedcba   (cv2 BORDER_REFLECT_101)
  kReflect = 1,     // fedcba|abcdefgh|hgfedcb   (cv2 BORDER_REFLECT)
  kReplicate = 2,   // aaaaaa|abcdefgh|hhhhhhh   (cv2 BORDER_REPLICATE)
  kWrap = 3,        // cdefgh|abcdefgh|abcdefg   (cv2 BORDER_WRAP)
  kConstant = 4,    // iiiiii|abcdefgh|iiiiiii   (cv2 BORDER_CONSTANT)
};

// Map an out-of-range coordinate into [0, n). Returns -1 for kConstant OOB.
// Multi-bounce (kernel wider than the image) handled by iteration, matching
// cv2::borderInterpolate.
inline int map_coord(int p, int n, int border) {
  if (p >= 0 && p < n) return p;
  switch (border) {
    case kReplicate:
      return p < 0 ? 0 : n - 1;
    case kWrap: {
      int m = p % n;
      return m < 0 ? m + n : m;
    }
    case kReflect:
      while (p < 0 || p >= n) {
        if (p < 0) p = -p - 1;
        if (p >= n) p = 2 * n - 1 - p;
      }
      return p;
    case kReflect101:
      if (n == 1) return 0;
      while (p < 0 || p >= n) {
        if (p < 0) p = -p;
        if (p >= n) p = 2 * (n - 1) - p;
      }
      return p;
    default:
      return -1;  // kConstant
  }
}

// One 1-D correlation pass along x for a single row of interleaved channels:
// dst[x*c + ch] = sum_t k[t] * src[(x + t - anchor)*c + ch]  (border-mapped).
void conv_row_f32(const float* src, float* dst, int n, int c, const float* k,
                  int kn, int anchor, int border, float fill) {
  const int lo = anchor;                // taps reach src index x - anchor
  const int hi = kn - 1 - anchor;       // ... through x + (kn-1-anchor)
  // interior: no border mapping needed for x in [lo, n - hi)
  int x0 = lo < n ? lo : n;
  int x1 = n - hi;
  if (x1 < x0) x1 = x0;
  auto edge = [&](int x) {
    for (int ch = 0; ch < c; ch++) {
      float acc = 0.0f;
      for (int t = 0; t < kn; t++) {
        int p = map_coord(x + t - anchor, n, border);
        acc += k[t] * (p < 0 ? fill : src[(size_t)p * c + ch]);
      }
      dst[(size_t)x * c + ch] = acc;
    }
  };
  for (int x = 0; x < x0; x++) edge(x);
  for (int x = x0; x < x1; x++) {
    const float* s = src + (size_t)(x - anchor) * c;
    for (int ch = 0; ch < c; ch++) {
      float acc = 0.0f;
      for (int t = 0; t < kn; t++) acc += k[t] * s[(size_t)t * c + ch];
      dst[(size_t)x * c + ch] = acc;
    }
  }
  for (int x = x1; x < n; x++) edge(x);
}

}  // namespace

extern "C" {

// Separable 2-D correlation on an HWC float32 image: vertical window `ky`
// then horizontal `kx`, anchors default to the window center when < 0.
// border: Border enum above; `fill` used for kConstant.
int dali_tpu_torch_sep_conv_f32(const float* src, int h, int w, int c,
                          const float* ky, int kyn, const float* kx, int kxn,
                          int anchor_y, int anchor_x, int border, float fill,
                          float* dst) {
  if (h < 1 || w < 1 || c < 1 || kyn < 1 || kxn < 1) return -1;
  if (anchor_y < 0) anchor_y = kyn / 2;
  if (anchor_x < 0) anchor_x = kxn / 2;
  if (anchor_y >= kyn || anchor_x >= kxn) return -1;
  const size_t row = (size_t)w * c;
  // vertical pass: accumulate the ky-window rows (border-mapped) row-wise,
  // one output row at a time.
  std::vector<float> tmp((size_t)h * row);
  for (int y = 0; y < h; y++) {
    float* drow = tmp.data() + (size_t)y * row;
    std::fill(drow, drow + row, 0.0f);
    for (int t = 0; t < kyn; t++) {
      const float kv = ky[t];
      if (kv == 0.0f) continue;
      int p = map_coord(y + t - anchor_y, h, border);
      if (p < 0) {  // constant border: whole row is `fill`
        const float add = kv * fill;
        for (size_t i = 0; i < row; i++) drow[i] += add;
        continue;
      }
      const float* srow = src + (size_t)p * row;
      for (size_t i = 0; i < row; i++) drow[i] += kv * srow[i];
    }
  }
  // horizontal pass
  for (int y = 0; y < h; y++)
    conv_row_f32(tmp.data() + (size_t)y * row, dst + (size_t)y * row, w, c,
                 kx, kxn, anchor_x, border, fill);
  return 0;
}

// General 2-D correlation with an arbitrary kh x kw kernel (cv2.filter2D
// semantics: dst(y,x) = sum_{i,j} kern(i,j) * src(y+i-ay, x+j-ax)).
int dali_tpu_torch_filter2d_f32(const float* src, int h, int w, int c,
                          const float* kern, int kh, int kw, int anchor_y,
                          int anchor_x, int border, float fill, float* dst) {
  if (h < 1 || w < 1 || c < 1 || kh < 1 || kw < 1) return -1;
  if (anchor_y < 0) anchor_y = kh / 2;
  if (anchor_x < 0) anchor_x = kw / 2;
  if (anchor_y >= kh || anchor_x >= kw) return -1;
  const size_t row = (size_t)w * c;
  const int lo_x = anchor_x, hi_x = kw - 1 - anchor_x;
  int x0 = lo_x < w ? lo_x : w;
  int x1 = w - hi_x;
  if (x1 < x0) x1 = x0;
  for (int y = 0; y < h; y++) {
    float* drow = dst + (size_t)y * row;
    // resolve the kh source rows once per output row
    // (p[i] < 0 means constant-border fill row)
    std::vector<const float*> rows(kh);
    for (int i = 0; i < kh; i++) {
      int p = map_coord(y + i - anchor_y, h, border);
      rows[i] = p < 0 ? nullptr : src + (size_t)p * row;
    }
    auto edge = [&](int x) {
      for (int ch = 0; ch < c; ch++) {
        float acc = 0.0f;
        for (int i = 0; i < kh; i++)
          for (int j = 0; j < kw; j++) {
            int p = map_coord(x + j - anchor_x, w, border);
            float v = (rows[i] == nullptr || p < 0)
                          ? fill
                          : rows[i][(size_t)p * c + ch];
            acc += kern[(size_t)i * kw + j] * v;
          }
        drow[(size_t)x * c + ch] = acc;
      }
    };
    for (int x = 0; x < x0; x++) edge(x);
    for (int x = x0; x < x1; x++) {
      for (int ch = 0; ch < c; ch++) {
        float acc = 0.0f;
        for (int i = 0; i < kh; i++) {
          const float* s =
              rows[i] ? rows[i] + (size_t)(x - anchor_x) * c + ch : nullptr;
          const float* kr = kern + (size_t)i * kw;
          if (s) {
            for (int j = 0; j < kw; j++) acc += kr[j] * s[(size_t)j * c];
          } else {
            float ks = 0.0f;
            for (int j = 0; j < kw; j++) ks += kr[j];
            acc += ks * fill;
          }
        }
        drow[(size_t)x * c + ch] = acc;
      }
    }
    for (int x = x1; x < w; x++) edge(x);
  }
  return 0;
}

}  // extern "C"

namespace {

// Bilinear Bayer->RGB demosaic, the host twin of the gpu placement
// (backend/straggler_gpu.py DebayerGPU): per color, mask-normalized 3x3 tent
// interpolation num/den with zero padding. Every accumulator is an exact
// small integer (< 2^24 even for u16 inputs), so the f32 division and the
// round half to even below equal the gpu's f32 convolution, divide and
// round.
template <typename T>
void debayer_bilinear(const T* in, int h, int w, int by, int bx, T* out) {
  static const int K[3][3] = {{1, 2, 1}, {2, 4, 2}, {1, 2, 1}};
  const int ry = 1 - by, rx = 1 - bx;  // red is diagonal from blue
  for (int y = 0; y < h; y++) {
    for (int x = 0; x < w; x++) {
      long num[3] = {0, 0, 0};
      int den[3] = {0, 0, 0};
      for (int dy = -1; dy <= 1; dy++) {
        int yy = y + dy;
        if (yy < 0 || yy >= h) continue;
        for (int dx = -1; dx <= 1; dx++) {
          int xx = x + dx;
          if (xx < 0 || xx >= w) continue;
          int kw = K[dy + 1][dx + 1];
          int c;  // which color this Bayer site carries
          if ((yy & 1) == by && (xx & 1) == bx) c = 2;       // blue
          else if ((yy & 1) == ry && (xx & 1) == rx) c = 0;  // red
          else c = 1;                                        // green
          num[c] += (long)kw * in[(size_t)yy * w + xx];
          den[c] += kw;
        }
      }
      T* o = out + ((size_t)y * w + x) * 3;
      for (int c = 0; c < 3; c++) {
        // den >= 1 always: any in-bounds 3x3 corner window still spans all
        // four 2x2 phases. f32 division of exact ints.
        float v = (float)num[c] / (float)den[c];
        float r = std::nearbyintf(v);  // round half to even
        long iv = (long)r;
        long hi = (long)std::numeric_limits<T>::max();
        o[c] = (T)(iv < 0 ? 0 : iv > hi ? hi : iv);
      }
    }
  }
}

}  // namespace

extern "C" {

int dali_tpu_torch_debayer_bilinear_u8(const unsigned char* in, int h, int w,
                                 int by, int bx, unsigned char* out) {
  if (!in || !out || h < 2 || w < 2 || by < 0 || by > 1 || bx < 0 || bx > 1)
    return -1;
  debayer_bilinear<unsigned char>(in, h, w, by, bx, out);
  return 0;
}

int dali_tpu_torch_debayer_bilinear_u16(const unsigned short* in, int h, int w,
                                  int by, int bx, unsigned short* out) {
  if (!in || !out || h < 2 || w < 2 || by < 0 || by > 1 || bx < 0 || bx > 1)
    return -1;
  debayer_bilinear<unsigned short>(in, h, w, by, bx, out);
  return 0;
}

}  // extern "C"

// ==================================== edge-aware debayer ====================================

namespace {

// OpenCV's Bayer2RGB_EdgeAware_T (demosaicing.cpp): the interior pixels from
// the 3x3 neighbourhood, green by the smaller of the horizontal and vertical
// gradients; then the first and last columns of each row copied from their
// neighbours, and the first and last rows likewise. out is [h, w, 3] in
// OpenCV's channel order for the pattern (start_with_green, blue).
template <typename T>
void debayer_ea(const T* src, int h, int w, int start_with_green, int blue, T* dst) {
  const int dcn = 3, dcn2 = 6;
  const long sstep = w, dstep = (long)w * 3;
  std::fill(dst, dst + (size_t)h * dstep, T(0));
  if (w <= 2 || h <= 2) return;
  const int width = w - 2, height = h - 2;
  const T* S = src + sstep + 1;
  T* D = dst + dstep + dcn;
  auto green = [&](const T* s) {
    return (std::abs(s[-1] - s[1]) > std::abs(s[sstep] - s[-sstep]) ? (s[sstep] + s[-sstep] + 1)
                                                                      : (s[-1] + s[1] + 1)) >>
           1;
  };
  auto diag = [&](const T* s) {
    return (s[-sstep - 1] + s[-sstep + 1] + s[sstep - 1] + s[sstep + 1] + 2) >> 2;
  };
  for (int y = 0; y < height; ++y) {
    int x = 1;
    if (start_with_green) {
      D[blue << 1] = (T)((S[-sstep] + S[sstep] + 1) >> 1);
      D[1] = S[0];
      D[2 - (blue << 1)] = (T)((S[-1] + S[1] + 1) >> 1);
      D += dcn;
      ++S;
      ++x;
    }
    if (blue) {
      for (; x < width; x += 2, S += 2, D += dcn2) {
        D[0] = S[0];
        D[1] = (T)green(S);
        D[2] = (T)diag(S);
        D[3] = (T)((S[0] + S[2] + 1) >> 1);
        D[4] = S[1];
        D[5] = (T)((S[-sstep + 1] + S[sstep + 1] + 1) >> 1);
      }
    } else {
      for (; x < width; x += 2, S += 2, D += dcn2) {
        D[0] = (T)diag(S);
        D[1] = (T)green(S);
        D[2] = S[0];
        D[3] = (T)((S[-sstep + 1] + S[sstep + 1] + 1) >> 1);
        D[4] = S[1];
        D[5] = (T)((S[0] + S[2] + 1) >> 1);
      }
    }
    if (x <= width) {
      D[blue << 1] = (T)diag(S);
      D[1] = (T)green(S);
      D[2 - (blue << 1)] = S[0];
      D += dcn;
      ++S;
    }
    for (int i = 0; i < dcn; ++i) {
      D[i] = D[-dcn + i];
      D[-dstep + dcn + i] = D[-dstep + (dcn << 1) + i];
    }
    start_with_green ^= 1;
    blue ^= 1;
    S += 2;
    D += 2 * dcn;
  }
  T* first = dst;
  T* last = dst + (size_t)(h - 1) * dstep;
  for (long x = 0; x < dstep; ++x) {
    first[x] = first[dstep + x];
    last[x] = last[x - dstep];
  }
}

}  // namespace

extern "C" {

int dali_tpu_torch_debayer_ea_u8(const unsigned char* in, int h, int w, int start_with_green,
                                 int blue, unsigned char* out) {
  if (!in || !out || h < 1 || w < 1) return -1;
  debayer_ea<unsigned char>(in, h, w, start_with_green != 0, blue != 0, out);
  return 0;
}

int dali_tpu_torch_debayer_ea_u16(const unsigned short* in, int h, int w, int start_with_green,
                                  int blue, unsigned short* out) {
  if (!in || !out || h < 1 || w < 1) return -1;
  debayer_ea<unsigned short>(in, h, w, start_with_green != 0, blue != 0, out);
  return 0;
}

}  // extern "C"
