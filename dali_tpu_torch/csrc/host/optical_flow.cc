// Dense optical flow between two grey frames: Gunnar Farneback's polynomial
// expansion method, rebuilt from OpenCV 5.0's calcOpticalFlowFarneback
// (video/src/optflowgf.cpp) with the arguments the OpticalFlow operator
// passes: pyr_scale 0.5, levels 3, winsize 15, iterations 3, poly_n 5,
// poly_sigma 1.2, no flags (a box window, no initial flow).
//
// The steps keep OpenCV's arithmetic, so that the flow equals cv2's bit for
// bit where the summation order allows:
// * the pyramid: each level blurs the full-size frame with GaussianBlur
//   (cv::getGaussianKernel's taps as float, a separable filter with
//   BORDER_REFLECT_101) and resizes it with INTER_LINEAR; the coarser
//   level's flow is resized and doubled;
// * FarnebackPolyExp: the Gaussian-weighted quadratic fit, its Gaussian and
//   the inverse of its 6x6 Gram matrix prepared in double (cv::Cholesky);
// * FarnebackUpdateMatrices and FarnebackUpdateFlow_Blur: the displacement
//   matrices, and their box-window average kept as double running sums,
//   with the +1e-3 of the determinant.
// Compiled with -ffp-contract=off: every fused multiply-add below is one
// that the cv2 build the reference runs performs on an x86-64 machine with
// AVX2 (its GaussianBlur and resize use them).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// cvRound: the SSE2 conversion, round half to even
inline int cv_round(double v) { return (int)std::nearbyint(v); }

inline int cv_floor(float v) {
  int i = (int)v;
  return i - (i > v);
}

inline int reflect101(int p, int len) {
  if (len == 1) return 0;
  while (p < 0 || p >= len) p = p < 0 ? -p : 2 * len - 2 - p;
  return p;
}

// cv::getGaussianKernel(n, sigma, CV_32F): the fixed binomial taps for
// sigma <= 0 (the pyramid asks for it with n == 3 only), else
// exp(-x^2 / (2 sigma^2)) normalised in double
void gaussian_kernel(int n, double sigma, float* k) {
  if (sigma <= 0) {
    k[0] = k[2] = 0.25f;
    k[1] = 0.5f;
    return;
  }
  const double scale2x = -0.125 / (sigma * sigma);
  const int n2 = (n - 1) / 2;
  std::vector<double> v(n2 + 1);
  double sum = 0;
  for (int i = 0, x = 1 - n; i < n2; i++, x += 2) {
    v[i] = std::exp((double)(x * x) * scale2x);
    sum += v[i];
  }
  sum = sum * 2 + 1;
  const double mul = 1 / sum;
  for (int i = 0; i < n2; i++) k[i] = k[n - 1 - i] = (float)(v[i] * mul);
  k[n2] = (float)mul;
}

// cv::GaussianBlur(src, dst, (n, n), sigma, sigma) of one float plane: the
// horizontal pass, then the vertical, each with BORDER_REFLECT_101. The
// rounding follows the code cv2 runs on an x86-64 machine with AVX2 (held
// against it in the tests): three taps sum a row in pairs of pixels as
// fma(centre, k1, (left + right) * k0), an odd last pixel as
// fma(left + right, k0, centre * k1), and a column as the latter; more taps
// sum a row as a fused chain over the taps, left to right, up to the last
// multiple of 4 pixels and unfused after it, and a column from the centre
// outward, fused up to the last multiple of 8 pixels and unfused after it.
void gaussian_blur(const float* src, int h, int w, int n, double sigma, float* dst) {
  std::vector<float> k(n), ext(w + n);
  thread_local std::vector<float> tmp;
  tmp.resize((size_t)h * w);
  gaussian_kernel(n, sigma, k.data());
  const int r = n / 2;
  for (int y = 0; y < h; y++) {
    const float* s = src + (size_t)y * w;
    for (int x = -r; x < w + r; x++) ext[x + r] = s[reflect101(x, w)];
    float* d = tmp.data() + (size_t)y * w;
    const float* e = ext.data() + r;
    if (n == 3) {
      const int paired = w / 2 * 2;
      for (int x = 0; x < paired; x++) d[x] = std::fma(e[x], k[1], (e[x - 1] + e[x + 1]) * k[0]);
      if (paired < w) d[w - 1] = std::fma(e[w - 2] + e[w], k[0], e[w - 1] * k[1]);
    } else {
      const int fused = w / 4 * 4;
      for (int x = 0; x < w; x++) {
        float acc = e[x - r] * k[0];
        if (x < fused)
          for (int t = 1; t < n; t++) acc = std::fma(e[x - r + t], k[t], acc);
        else
          for (int t = 1; t < n; t++) acc = acc + e[x - r + t] * k[t];
        d[x] = acc;
      }
    }
  }
  const int fused = n == 3 ? w : w / 8 * 8;
  for (int y = 0; y < h; y++) {
    float* d = dst + (size_t)y * w;
    const float* c = tmp.data() + (size_t)y * w;
    for (int x = 0; x < w; x++) {
      float acc = c[x] * k[r];
      for (int t = 1; t <= r; t++) {
        const float a = tmp[(size_t)reflect101(y - t, h) * w + x];
        const float b = tmp[(size_t)reflect101(y + t, h) * w + x];
        acc = x < fused ? std::fma(a + b, k[r - t], acc) : acc + (a + b) * k[r - t];
      }
      d[x] = acc;
    }
  }
}

// The interpolation positions of cv::resize's INTER_LINEAR along one axis:
// source index and weight of the next sample, clamped at the edges (with
// clamp). cv2 rounds the position to float before splitting it for
// multi-channel images, and keeps it in double for one channel.
void linear_coeffs(int dn, int sn, bool float_pos, bool clamp, int* ofs, float* a) {
  const double scale = 1. / ((double)dn / sn);
  for (int d = 0; d < dn; d++) {
    const double pos = (d + 0.5) * scale - 0.5;
    int s;
    float f;
    if (float_pos) {
      f = (float)pos;
      s = cv_floor(f);
      f -= s;
    } else {
      s = (int)std::floor(pos);
      f = (float)(pos - s);
    }
    if (clamp && s < 0) f = 0, s = 0;
    if (clamp && s >= sn - 1) f = 0, s = sn - 1;
    ofs[d] = s;
    a[d] = f;
  }
}

// cv::resize(src, dst, (dw, dh), INTER_LINEAR) of an interleaved float image.
// One channel (cv2's route for it, held against cv2 in the tests): each
// pass interpolates as fma(next - this, weight, this), rows first. More
// channels: OpenCV's generic code, this * (1 - weight) + next * weight,
// whose vertical weights are not clamped at the edges (the rows are).
void resize_linear(const float* src, int h, int w, int cn, float* dst, int dh, int dw) {
  const bool one = cn == 1;
  std::vector<int> xofs(dw), yofs(dh);
  std::vector<float> ax(dw), ay(dh);
  linear_coeffs(dw, w, !one, true, xofs.data(), ax.data());
  linear_coeffs(dh, h, !one, one, yofs.data(), ay.data());
  const size_t drow = (size_t)dw * cn;
  std::vector<float> rows(2 * drow);
  auto hrow = [&](int sy, float* out) {
    const float* s = src + (size_t)sy * w * cn;
    for (int dx = 0; dx < dw; dx++) {
      const float* p0 = s + (size_t)xofs[dx] * cn;
      const float* p1 = s + (size_t)std::min(xofs[dx] + 1, w - 1) * cn;
      const float a1 = ax[dx], a0 = 1.f - a1;
      for (int c = 0; c < cn; c++)
        out[dx * cn + c] = one ? std::fma(p1[c] - p0[c], a1, p0[c]) : p0[c] * a0 + p1[c] * a1;
    }
  };
  for (int dy = 0; dy < dh; dy++) {
    hrow(std::min(std::max(yofs[dy], 0), h - 1), rows.data());
    hrow(std::min(std::max(yofs[dy] + 1, 0), h - 1), rows.data() + drow);
    const float b1 = ay[dy], b0 = 1.f - b1;
    const float* r0 = rows.data();
    const float* r1 = r0 + drow;
    float* d = dst + (size_t)dy * drow;
    for (size_t i = 0; i < drow; i++)
      d[i] = one ? std::fma(r1[i] - r0[i], b1, r0[i]) : r0[i] * b0 + r1[i] * b1;
  }
}

// cv::invert(G, DECOMP_CHOLESKY) of a symmetric positive 6x6 matrix (in place
// on a, the inverse in b): OpenCV's CholImpl with b the identity
void cholesky_inverse(double* a, double* b, int m) {
  for (int i = 0; i < m; i++) {
    int j;
    for (j = 0; j < i; j++) {
      double s = a[i * m + j];
      for (int k = 0; k < j; k++) s -= a[i * m + k] * a[j * m + k];
      a[i * m + j] = s * a[j * m + j];
    }
    double s = a[i * m + i];
    for (int k = 0; k < j; k++) {
      const double t = a[i * m + k];
      s -= t * t;
    }
    a[i * m + i] = 1. / std::sqrt(s);
  }
  for (int i = 0; i < m; i++)
    for (int j = 0; j < m; j++) b[i * m + j] = i == j;
  for (int i = 0; i < m; i++)
    for (int j = 0; j < m; j++) {
      double s = b[i * m + j];
      for (int k = 0; k < i; k++) s -= a[i * m + k] * b[k * m + j];
      b[i * m + j] = s * a[i * m + i];
    }
  for (int i = m - 1; i >= 0; i--)
    for (int j = 0; j < m; j++) {
      double s = b[i * m + j];
      for (int k = m - 1; k > i; k--) s -= a[k * m + i] * b[k * m + j];
      b[i * m + j] = s * a[i * m + i];
    }
}

struct PolyGauss {
  std::vector<float> buf;
  float *g, *xg, *xxg;
  double ig11, ig03, ig33, ig55;
};

// FarnebackPrepareGaussian
void prepare_gaussian(int n, double sigma, PolyGauss* pg) {
  pg->buf.assign(3 * (2 * n + 1), 0.f);
  float* g = pg->buf.data() + n;
  float* xg = g + 2 * n + 1;
  float* xxg = xg + 2 * n + 1;
  double s = 0.;
  for (int x = -n; x <= n; x++) {
    g[x] = (float)std::exp(-x * x / (2 * sigma * sigma));
    s += g[x];
  }
  s = 1. / s;
  for (int x = -n; x <= n; x++) {
    g[x] = (float)(g[x] * s);
    xg[x] = (float)(x * g[x]);
    xxg[x] = (float)(x * x * g[x]);
  }
  double G[36] = {0}, iG[36];
  for (int y = -n; y <= n; y++)
    for (int x = -n; x <= n; x++) {
      G[0] += g[y] * g[x];
      G[7] += g[y] * g[x] * x * x;
      G[21] += g[y] * g[x] * x * x * x * x;
      G[35] += g[y] * g[x] * x * x * y * y;
    }
  G[14] = G[3] = G[4] = G[18] = G[24] = G[7];
  G[28] = G[21];
  G[22] = G[27] = G[35];
  cholesky_inverse(G, iG, 6);
  pg->g = g;
  pg->xg = xg;
  pg->xxg = xxg;
  pg->ig11 = iG[7];
  pg->ig03 = iG[3];
  pg->ig33 = iG[21];
  pg->ig55 = iG[35];
}

// FarnebackPolyExp: dst [h, w, 5] float
void poly_exp(const float* src, int h, int w, int n, const PolyGauss& pg, float* dst) {
  const float *g = pg.g, *xg = pg.xg, *xxg = pg.xxg;
  std::vector<float> rowbuf((size_t)(w + 2 * n) * 3);
  float* row = rowbuf.data() + n * 3;
  for (int y = 0; y < h; y++) {
    float g0 = g[0], g1, g2;
    const float* srow0 = src + (size_t)y * w;
    float* drow = dst + (size_t)y * w * 5;
    for (int x = 0; x < w; x++) {
      row[x * 3] = srow0[x] * g0;
      row[x * 3 + 1] = row[x * 3 + 2] = 0.f;
    }
    for (int k = 1; k <= n; k++) {
      g0 = g[k];
      g1 = xg[k];
      g2 = xxg[k];
      srow0 = src + (size_t)std::max(y - k, 0) * w;
      const float* srow1 = src + (size_t)std::min(y + k, h - 1) * w;
      for (int x = 0; x < w; x++) {
        float p = srow0[x] + srow1[x];
        float t0 = row[x * 3] + g0 * p;
        float t1 = row[x * 3 + 1] + g1 * (srow1[x] - srow0[x]);
        float t2 = row[x * 3 + 2] + g2 * p;
        row[x * 3] = t0;
        row[x * 3 + 1] = t1;
        row[x * 3 + 2] = t2;
      }
    }
    for (int x = 0; x < n * 3; x++) {
      row[-1 - x] = row[2 - x];
      row[w * 3 + x] = row[w * 3 + x - 3];
    }
    for (int x = 0; x < w; x++) {
      g0 = g[0];
      double b1 = row[x * 3] * g0, b2 = 0, b3 = row[x * 3 + 1] * g0, b4 = 0,
             b5 = row[x * 3 + 2] * g0, b6 = 0;
      for (int k = 1; k <= n; k++) {
        double tg = row[(x + k) * 3] + row[(x - k) * 3];
        g0 = g[k];
        b1 += tg * g0;
        b4 += tg * xxg[k];
        b2 += (row[(x + k) * 3] - row[(x - k) * 3]) * xg[k];
        b3 += (row[(x + k) * 3 + 1] + row[(x - k) * 3 + 1]) * g0;
        b6 += (row[(x + k) * 3 + 1] - row[(x - k) * 3 + 1]) * xg[k];
        b5 += (row[(x + k) * 3 + 2] + row[(x - k) * 3 + 2]) * g0;
      }
      drow[x * 5 + 1] = (float)(b2 * pg.ig11);
      drow[x * 5] = (float)(b3 * pg.ig11);
      drow[x * 5 + 3] = (float)(b1 * pg.ig03 + b4 * pg.ig33);
      drow[x * 5 + 2] = (float)(b1 * pg.ig03 + b5 * pg.ig33);
      drow[x * 5 + 4] = (float)(b6 * pg.ig55);
    }
  }
}

// FarnebackUpdateMatrices over rows [y0, y1)
void update_matrices(const float* R0, const float* R1, const float* flow, float* M, int h,
                     int w, int y0, int y1) {
  const int BORDER = 5;
  static const float border[BORDER] = {0.14f, 0.14f, 0.4472f, 0.4472f, 0.4472f};
  const size_t step1 = (size_t)w * 5;
  for (int y = y0; y < y1; y++) {
    const float* fl = flow + (size_t)y * w * 2;
    const float* r0 = R0 + (size_t)y * step1;
    float* m = M + (size_t)y * step1;
    for (int x = 0; x < w; x++) {
      float dx = fl[x * 2], dy = fl[x * 2 + 1];
      float fx = x + dx, fy = y + dy;
      int x1 = cv_floor(fx), y1_ = cv_floor(fy);
      float r2, r3, r4, r5, r6;
      fx -= x1;
      fy -= y1_;
      if ((unsigned)x1 < (unsigned)(w - 1) && (unsigned)y1_ < (unsigned)(h - 1)) {
        const float* ptr = R1 + (size_t)y1_ * step1 + (size_t)x1 * 5;
        float a00 = (1.f - fx) * (1.f - fy), a01 = fx * (1.f - fy), a10 = (1.f - fx) * fy,
              a11 = fx * fy;
        r2 = a00 * ptr[0] + a01 * ptr[5] + a10 * ptr[step1] + a11 * ptr[step1 + 5];
        r3 = a00 * ptr[1] + a01 * ptr[6] + a10 * ptr[step1 + 1] + a11 * ptr[step1 + 6];
        r4 = a00 * ptr[2] + a01 * ptr[7] + a10 * ptr[step1 + 2] + a11 * ptr[step1 + 7];
        r5 = a00 * ptr[3] + a01 * ptr[8] + a10 * ptr[step1 + 3] + a11 * ptr[step1 + 8];
        r6 = a00 * ptr[4] + a01 * ptr[9] + a10 * ptr[step1 + 4] + a11 * ptr[step1 + 9];
        r4 = (r0[x * 5 + 2] + r4) * 0.5f;
        r5 = (r0[x * 5 + 3] + r5) * 0.5f;
        r6 = (r0[x * 5 + 4] + r6) * 0.25f;
      } else {
        r2 = r3 = 0.f;
        r4 = r0[x * 5 + 2];
        r5 = r0[x * 5 + 3];
        r6 = r0[x * 5 + 4] * 0.5f;
      }
      r2 = (r0[x * 5] - r2) * 0.5f;
      r3 = (r0[x * 5 + 1] - r3) * 0.5f;
      r2 += r4 * dy + r6 * dx;
      r3 += r6 * dy + r5 * dx;
      if ((unsigned)(x - BORDER) >= (unsigned)(w - BORDER * 2) ||
          (unsigned)(y - BORDER) >= (unsigned)(h - BORDER * 2)) {
        float scale = (x < BORDER ? border[x] : 1.f) *
                      (x >= w - BORDER ? border[w - x - 1] : 1.f) *
                      (y < BORDER ? border[y] : 1.f) *
                      (y >= h - BORDER ? border[h - y - 1] : 1.f);
        r2 *= scale;
        r3 *= scale;
        r4 *= scale;
        r5 *= scale;
        r6 *= scale;
      }
      m[x * 5] = r4 * r4 + r6 * r6;
      m[x * 5 + 1] = (r4 + r5) * r6;
      m[x * 5 + 2] = r5 * r5 + r6 * r6;
      m[x * 5 + 3] = r4 * r2 + r6 * r3;
      m[x * 5 + 4] = r6 * r2 + r5 * r3;
    }
  }
}

// FarnebackUpdateFlow_Blur: the flow from the box-window average of M, then
// (update_matrices) M from the new flow
void update_flow_blur(const float* R0, const float* R1, float* flow, float* M, int h, int w,
                      int block_size, bool update) {
  const int m = block_size / 2;
  const double scale = 1. / (block_size * block_size);
  std::vector<double> vbuf((size_t)(w + m * 2 + 2) * 5);
  double* vsum = vbuf.data() + (m + 1) * 5;
  const float* srow0 = M;
  for (int x = 0; x < w * 5; x++) vsum[x] = srow0[x] * (m + 2);
  for (int y = 1; y < m; y++) {
    srow0 = M + (size_t)std::min(y, h - 1) * w * 5;
    for (int x = 0; x < w * 5; x++) vsum[x] += srow0[x];
  }
  for (int y = 0; y < h; y++) {
    float* fl = flow + (size_t)y * w * 2;
    srow0 = M + (size_t)std::max(y - m - 1, 0) * w * 5;
    const float* srow1 = M + (size_t)std::min(y + m, h - 1) * w * 5;
    for (int x = 0; x < w * 5; x++) vsum[x] += srow1[x] - srow0[x];
    for (int x = 0; x < (m + 1) * 5; x++) {
      vsum[-1 - x] = vsum[4 - x];
      vsum[w * 5 + x] = vsum[w * 5 + x - 5];
    }
    double g11 = vsum[0] * (m + 2), g12 = vsum[1] * (m + 2), g22 = vsum[2] * (m + 2),
           h1 = vsum[3] * (m + 2), h2 = vsum[4] * (m + 2);
    for (int x = 1; x < m; x++) {
      g11 += vsum[x * 5];
      g12 += vsum[x * 5 + 1];
      g22 += vsum[x * 5 + 2];
      h1 += vsum[x * 5 + 3];
      h2 += vsum[x * 5 + 4];
    }
    for (int x = 0; x < w; x++) {
      g11 += vsum[(x + m) * 5] - vsum[(x - m) * 5 - 5];
      g12 += vsum[(x + m) * 5 + 1] - vsum[(x - m) * 5 - 4];
      g22 += vsum[(x + m) * 5 + 2] - vsum[(x - m) * 5 - 3];
      h1 += vsum[(x + m) * 5 + 3] - vsum[(x - m) * 5 - 2];
      h2 += vsum[(x + m) * 5 + 4] - vsum[(x - m) * 5 - 1];
      double g11_ = g11 * scale, g12_ = g12 * scale, g22_ = g22 * scale, h1_ = h1 * scale,
             h2_ = h2 * scale;
      double idet = 1. / (g11_ * g22_ - g12_ * g12_ + 1e-3);
      fl[x * 2] = (float)((g11_ * h2_ - g12_ * h1_) * idet);
      fl[x * 2 + 1] = (float)((g22_ * h1_ - g12_ * h2_) * idet);
    }
  }
  // OpenCV updates M in stripes behind the rows it has read for the last
  // time; the rows it reads are never the updated ones, so one pass after
  // the flow gives the same matrices
  if (update) update_matrices(R0, R1, flow, M, h, w, 0, h);
}

constexpr double kPyrScale = 0.5;
constexpr int kLevels = 3, kWinSize = 15, kIterations = 3, kPolyN = 5;
constexpr double kPolySigma = 1.2;

}  // namespace

extern "C" {

// Farneback flow from grey frame a to grey frame b (float32 [h, w]) into
// flow (float32 [h, w, 2], x then y). Returns 0.
int dali_tpu_torch_farneback(const float* a, const float* b, int h, int w, float* flow) {
  const int min_size = 32;
  int levels = kLevels;
  double scale = 1;
  int k;
  for (k = 0; k < levels; k++) {
    scale *= kPyrScale;
    if (w * scale < min_size || h * scale < min_size) break;
  }
  levels = k;
  PolyGauss pg;
  prepare_gaussian(kPolyN, kPolySigma, &pg);
  // per-thread workspaces, kept across calls: the pool's threads would
  // otherwise serialise on mapping and faulting in fresh pages every call
  thread_local std::vector<float> prev_flow, cur, blur, lvl, R[2], M;
  prev_flow.clear();
  blur.resize((size_t)h * w);
  int pw = 0, ph = 0;
  for (k = levels; k >= 0; k--) {
    scale = 1;
    for (int i = 0; i < k; i++) scale *= kPyrScale;
    const double sigma = (1. / scale - 1) * 0.5;
    const int smooth_sz = std::max(cv_round(sigma * 5) | 1, 3);
    const int lw = cv_round(w * scale), lh = cv_round(h * scale);
    cur.assign((size_t)lw * lh * 2, 0.f);
    if (!prev_flow.empty()) {
      resize_linear(prev_flow.data(), ph, pw, 2, cur.data(), lh, lw);
      for (float& v : cur) v *= (float)(1. / kPyrScale);
    }
    for (int i = 0; i < 2; i++) {
      gaussian_blur(i ? b : a, h, w, smooth_sz, sigma, blur.data());
      lvl.resize((size_t)lw * lh);
      resize_linear(blur.data(), h, w, 1, lvl.data(), lh, lw);
      R[i].resize((size_t)lw * lh * 5);
      poly_exp(lvl.data(), lh, lw, kPolyN, pg, R[i].data());
    }
    M.resize((size_t)lw * lh * 5);
    update_matrices(R[0].data(), R[1].data(), cur.data(), M.data(), lh, lw, 0, lh);
    for (int i = 0; i < kIterations; i++)
      update_flow_blur(R[0].data(), R[1].data(), cur.data(), M.data(), lh, lw, kWinSize,
                       i < kIterations - 1);
    prev_flow.swap(cur);
    pw = lw;
    ph = lh;
  }
  std::memcpy(flow, prev_flow.data(), sizeof(float) * (size_t)w * h * 2);
  return 0;
}

// cv::cvtColor(COLOR_RGB2GRAY) of n float RGB pixels: cv2's vector code,
// fma(B, 0.114, fma(R, 0.299, G * 0.587)). Returns 0.
int dali_tpu_torch_rgb_to_gray_f32(const float* rgb, long long n, float* out) {
  for (long long i = 0; i < n; i++) {
    const float* p = rgb + 3 * i;
    out[i] = std::fma(p[2], 0.114f, std::fma(p[0], 0.299f, p[1] * 0.587f));
  }
  return 0;
}

// The pyramid's two resamplers, exposed for the tests that hold them
// against cv2: GaussianBlur of a float plane, and resize of an interleaved
// float image. Return 0.
int dali_tpu_torch_of_gaussian_blur(const float* src, int h, int w, int n, double sigma,
                                    float* dst) {
  gaussian_blur(src, h, w, n, sigma, dst);
  return 0;
}

int dali_tpu_torch_of_resize(const float* src, int h, int w, int cn, float* dst, int dh,
                             int dw) {
  resize_linear(src, h, w, cn, dst, dh, dw);
  return 0;
}

}  // extern "C"
